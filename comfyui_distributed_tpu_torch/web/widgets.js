// Pure prompt-graph widget logic (no DOM): divider dynamic outputs and
// host auto-populate helpers. Kept DOM-free so node:test can exercise it
// (scripts/test-web.sh) — parity with the reference's vitest'ed helpers
// (web/tests/), and with web/image_batch_divider.js:10-62 which grows/
// shrinks node outputs to divide_by.

export const DIVIDER_CLASSES = ["ImageBatchDivider", "AudioBatchDivider"];
export const MAX_DIVIDE = 10;

export function clampDivideBy(value) {
  const n = Math.floor(Number(value));
  if (!Number.isFinite(n)) return 1;
  return Math.max(1, Math.min(n, MAX_DIVIDE));
}

// [[nodeId, node], ...] for divider nodes in prompt-JSON order
export function dividerNodes(prompt) {
  if (!prompt || typeof prompt !== "object") return [];
  return Object.entries(prompt).filter(
    ([, n]) => n && DIVIDER_CLASSES.includes(n.class_type));
}

// Links from any node's inputs into `nodeId`'s outputs at index >=
// divideBy — the chunks that repeat the empty batch once divide_by
// shrinks (graph/nodes_builtin.py dividers). The dashboard warns on
// these instead of silently wiring empty outputs.
export function inactiveLinks(prompt, nodeId, divideBy) {
  const hits = [];
  if (!prompt) return hits;
  for (const [consumerId, node] of Object.entries(prompt)) {
    const inputs = (node && node.inputs) || {};
    for (const [inputName, v] of Object.entries(inputs)) {
      if (Array.isArray(v) && String(v[0]) === String(nodeId)
          && Number(v[1]) >= divideBy) {
        hits.push({ consumerId, inputName, outputIndex: Number(v[1]) });
      }
    }
  }
  return hits;
}

// Rows the auto-populate endpoint added, normalized for display
export function describeAddedHosts(result) {
  const hosts = (result && result.added) || [];
  return hosts.map((h) => `${h.id} → ${h.address}`).join(", ");
}
