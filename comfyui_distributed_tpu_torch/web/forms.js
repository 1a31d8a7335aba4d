// Workflow parameter forms: pure prompt-editing logic (no DOM).
//
// The reference's L6 lives inside ComfyUI's graph editor, so every node
// input is editable for free (web/executionUtils.js:6-23 hooks a full
// authoring environment). This standalone dashboard instead GENERATES
// edit forms from the node interface specs served by
// `GET /distributed/object_info` (graph/node.py INPUTS/OPTIONAL), writing
// edits through to the prompt JSON — edit-then-run without touching raw
// JSON (VERDICT r3 next #3). DOM-free so node:test can exercise it
// (scripts/test-web.sh).

// ComfyUI type name → form field kind; anything else (IMAGE, LATENT,
// MODEL, "*", …) is a graph edge or opaque object — not form-editable.
const KIND_BY_TYPE = {
  INT: "int",
  FLOAT: "float",
  STRING: "string",
  BOOLEAN: "boolean",
};

// Inputs that already have dedicated widget UIs (valueWidgets.js /
// widgets.js) — keep them out of the generic form so the same field
// doesn't render twice with diverging behavior.
const WIDGETED_FIELDS = new Set(["worker_values", "divide_by"]);

export function isLink(value) {
  // graph-edge encoding: [source_node_id, output_index] (graph/node.py:63)
  return Array.isArray(value) && value.length === 2
    && typeof value[0] === "string" && Number.isInteger(value[1]);
}

export function fieldKind(typeName) {
  return KIND_BY_TYPE[String(typeName || "").toUpperCase()] || null;
}

// Long free text (prompts, file lists) wants a textarea, not a one-line
// input. Heuristic: field name says "text"/"prompt", or the current value
// is already long.
export function isMultiline(field) {
  if (field.kind !== "string") return false;
  const name = field.name.toLowerCase();
  if (name.includes("text") || name.includes("prompt")) return true;
  return typeof field.value === "string" && field.value.length > 60;
}

// Flatten a prompt graph + object_info specs into an ordered list of
// editable scalar fields. Skips links (wired inputs), widgeted fields,
// and inputs whose declared type isn't a form scalar. Unknown node
// classes contribute nothing (a foreign workflow still renders, just
// without forms for those nodes).
export function editableFields(prompt, specs) {
  const nodes = (specs && specs.nodes) || specs || {};
  const out = [];
  if (!prompt || typeof prompt !== "object") return out;
  for (const [nodeId, node] of Object.entries(prompt)) {
    if (!node || typeof node !== "object") continue;
    const spec = nodes[node.class_type];
    if (!spec) continue;
    const inputs = node.inputs || {};
    const declared = { ...(spec.required || {}), ...(spec.optional || {}) };
    for (const [name, typeName] of Object.entries(declared)) {
      const kind = fieldKind(typeName);
      if (!kind || WIDGETED_FIELDS.has(name)) continue;
      const value = inputs[name];
      if (isLink(value)) continue;          // wired from another node
      out.push({
        nodeId,
        classType: node.class_type,
        name,
        kind,
        value: value === undefined ? null : value,
        optional: !(spec.required && name in spec.required),
      });
    }
  }
  return out;
}

// Parse + validate a raw form string for a field kind. Throws on values
// that would corrupt the prompt (NaN seeds, non-integer steps).
export function coerceFieldValue(kind, raw) {
  // Number("") === 0 — a cleared numeric field must be rejected, not
  // silently written as 0 (a 0-step run)
  const empty = typeof raw === "string" && raw.trim() === "";
  switch (kind) {
    case "int": {
      const n = Number(raw);
      if (empty || !Number.isFinite(n) || !Number.isInteger(n)) {
        throw new Error(`not an integer: ${JSON.stringify(raw)}`);
      }
      return n;
    }
    case "float": {
      const n = Number(raw);
      if (empty || !Number.isFinite(n)) {
        throw new Error(`not a number: ${JSON.stringify(raw)}`);
      }
      return n;
    }
    case "boolean":
      if (typeof raw === "boolean") return raw;
      return raw === "true" || raw === "1" || raw === 1;
    default:
      return String(raw);
  }
}

// Write one coerced field edit into a prompt object (mutates; returns the
// coerced value so callers can reflect it back into the input).
export function applyFieldEdit(prompt, nodeId, name, kind, raw) {
  const node = prompt && prompt[nodeId];
  if (!node) throw new Error(`no node ${nodeId} in prompt`);
  const value = coerceFieldValue(kind, raw);
  node.inputs = node.inputs || {};
  node.inputs[name] = value;
  return value;
}

// Preflight prompt lint, mirroring the server's validate_prompt rules
// (graph/executor.py:37-79: unknown class, missing required input,
// dangling link, bad output index) plus an unknown-input-name warning
// (the executor silently drops those at run time). The reference's
// graph editor prevents these structurally; a JSON-first dashboard
// must lint instead. Returns [{nodeId, level: "error"|"warning",
// message}] — empty = clean.
export function lintPrompt(prompt, specs) {
  const nodes = (specs && specs.nodes) || specs || {};
  const issues = [];
  if (!prompt || typeof prompt !== "object") return issues;
  const push = (nodeId, level, message) =>
    issues.push({ nodeId, level, message });
  for (const [nodeId, node] of Object.entries(prompt)) {
    if (nodeId.startsWith("_")) continue;   // _meta etc. — server strips
    if (!node || typeof node !== "object" || !node.class_type) {
      push(nodeId, "error", "node must have class_type");
      continue;
    }
    const spec = nodes[node.class_type];
    if (!spec) {
      // only an error when we have specs at all (no specs = can't know)
      if (Object.keys(nodes).length) {
        push(nodeId, "error", `unknown node class ${node.class_type}`);
      }
      continue;
    }
    const inputs = node.inputs || {};
    for (const name of Object.keys(spec.required || {})) {
      if (inputs[name] === undefined) {
        push(nodeId, "error", `missing required input ${name}`);
      }
    }
    const declared = new Set([
      ...Object.keys(spec.required || {}),
      ...Object.keys(spec.optional || {}),
    ]);
    for (const [name, value] of Object.entries(inputs)) {
      if (!declared.has(name)) {
        push(nodeId, "warning",
             `input ${name} is not declared by ${node.class_type} ` +
             "(the executor ignores it)");
      }
      if (isLink(value)) {
        const [src, outIdx] = value;
        const srcNode = prompt[src];
        if (!srcNode) {
          push(nodeId, "error",
               `input ${name} links to missing node ${src}`);
        } else {
          const srcSpec = nodes[srcNode.class_type];
          if (srcSpec && outIdx >= (srcSpec.returns || []).length) {
            push(nodeId, "error",
                 `input ${name} links to output ${outIdx} of ` +
                 `${srcNode.class_type} which has ` +
                 `${(srcSpec.returns || []).length}`);
          }
        }
      }
    }
  }
  // cycle check (validate_prompt runs topo_order; a cyclic prompt must
  // not lint clean). Iterative DFS over link edges.
  const state = new Map();                 // nodeId → 0 visiting, 1 done
  const links = (nid) =>
    Object.values((prompt[nid] && prompt[nid].inputs) || {})
      .filter((v) => isLink(v) && prompt[v[0]])
      .map((v) => v[0]);
  for (const start of Object.keys(prompt)) {
    if (start.startsWith("_") || state.get(start) === 1) continue;
    const stack = [[start, 0]];
    while (stack.length) {
      const top = stack[stack.length - 1];
      const [nid] = top;
      if (top[1] === 0) state.set(nid, 0);
      const deps = links(nid);
      if (top[1] < deps.length) {
        const next = deps[top[1]++];
        if (state.get(next) === 0) {
          push(next, "error", `cycle involving node ${next}`);
          state.set(next, 1);
        } else if (state.get(next) === undefined) {
          stack.push([next, 0]);
        }
      } else {
        state.set(nid, 1);
        stack.pop();
      }
    }
  }
  return issues;
}

// Group fields by node for rendering: [[{nodeId, classType}, fields], …]
// in prompt order.
export function groupByNode(fields) {
  const groups = new Map();
  for (const f of fields) {
    if (!groups.has(f.nodeId)) {
      groups.set(f.nodeId, { nodeId: f.nodeId, classType: f.classType, fields: [] });
    }
    groups.get(f.nodeId).fields.push(f);
  }
  return [...groups.values()];
}
