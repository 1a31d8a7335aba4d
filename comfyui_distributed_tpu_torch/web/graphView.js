// Read-only DAG view of the loaded workflow (r04 VERDICT next-round #6:
// the dashboard edited parameters but could not SHOW the graph a user is
// about to queue — the reference gets a full canvas from ComfyUI).
// Pure logic + SVG-string rendering, DOM-free so node:test can exercise
// every path (scripts/test-web.sh), same discipline as widgets.js.

const NODE_W = 168;
const NODE_H = 54;
const GAP_X = 64;
const GAP_Y = 24;
const PAD = 16;

function isLink(v) {
  return Array.isArray(v) && v.length === 2 &&
    typeof v[0] === "string" && Number.isInteger(v[1]);
}

// prompt JSON → {nodes, links}; tolerant of malformed input (returns
// empty model rather than throwing — the textarea is user-edited)
export function graphModel(prompt) {
  if (!prompt || typeof prompt !== "object" || Array.isArray(prompt)) {
    return { nodes: [], links: [] };
  }
  const nodes = [];
  const links = [];
  for (const [id, node] of Object.entries(prompt)) {
    if (id === "_meta" || !node || typeof node !== "object") continue;
    const inputs = node.inputs || {};
    const params = [];
    for (const [name, value] of Object.entries(inputs)) {
      if (isLink(value)) {
        links.push({ from: value[0], fromSlot: value[1], to: id, input: name });
      } else {
        params.push([name, value]);
      }
    }
    nodes.push({
      id,
      classType: String(node.class_type || "?"),
      params,
      outputNode: false,          // filled by caller from object_info
    });
  }
  const ids = new Set(nodes.map((n) => n.id));
  return { nodes, links: links.filter((l) => ids.has(l.from)) };
}

// longest-path layering: every node sits one column right of its
// deepest upstream source; cycles (invalid but typeable) terminate via
// the visiting set instead of recursing forever
export function layoutGraph(model) {
  const upstream = new Map();     // id → [from ids]
  for (const n of model.nodes) upstream.set(n.id, []);
  for (const l of model.links) upstream.get(l.to).push(l.from);

  const depth = new Map();
  const visiting = new Set();
  function depthOf(id) {
    if (depth.has(id)) return depth.get(id);
    if (visiting.has(id)) return 0;             // cycle guard
    visiting.add(id);
    const ups = upstream.get(id) || [];
    const d = ups.length ? 1 + Math.max(...ups.map(depthOf)) : 0;
    visiting.delete(id);
    depth.set(id, d);
    return d;
  }
  const columns = new Map();      // depth → [node ids]
  for (const n of model.nodes) {
    const d = depthOf(n.id);
    if (!columns.has(d)) columns.set(d, []);
    columns.get(d).push(n.id);
  }
  const pos = new Map();
  for (const [d, ids] of columns) {
    ids.forEach((id, row) => {
      pos.set(id, {
        x: PAD + d * (NODE_W + GAP_X),
        y: PAD + row * (NODE_H + GAP_Y),
      });
    });
  }
  const nCols = columns.size;
  const nRows = Math.max(0, ...[...columns.values()].map((c) => c.length));
  return {
    pos,
    width: PAD * 2 + Math.max(nCols, 1) * NODE_W + (nCols - 1) * GAP_X,
    height: PAD * 2 + Math.max(nRows, 1) * NODE_H + (nRows - 1) * GAP_Y,
  };
}

function esc(s) {
  return String(s).replace(/&/g, "&amp;").replace(/</g, "&lt;")
    .replace(/>/g, "&gt;").replace(/"/g, "&quot;");
}

function paramSummary(params, max = 2) {
  return params.slice(0, max).map(([k, v]) => {
    let text = typeof v === "string" ? v : JSON.stringify(v);
    if (text === undefined) text = "";
    if (text.length > 16) text = text.slice(0, 15) + "…";
    return `${k}=${text}`;
  }).join("  ");
}

// model + layout → one self-contained SVG string (no DOM needed; the
// dashboard injects it with innerHTML into the graph panel)
export function renderGraphSvg(model, outputClasses = new Set()) {
  const { pos, width, height } = layoutGraph(model);
  const parts = [
    `<svg class="graph-svg" viewBox="0 0 ${width} ${height}" ` +
    `width="${width}" height="${height}" xmlns="http://www.w3.org/2000/svg">`,
  ];
  for (const l of model.links) {
    const a = pos.get(l.from);
    const b = pos.get(l.to);
    if (!a || !b) continue;
    const x1 = a.x + NODE_W;
    const y1 = a.y + NODE_H / 2;
    const x2 = b.x;
    const y2 = b.y + NODE_H / 2;
    const mid = (x1 + x2) / 2;
    parts.push(
      `<path class="graph-link" d="M ${x1} ${y1} C ${mid} ${y1}, ` +
      `${mid} ${y2}, ${x2} ${y2}" fill="none"/>`);
  }
  for (const n of model.nodes) {
    const p = pos.get(n.id);
    if (!p) continue;
    const cls = "graph-node" +
      (outputClasses.has(n.classType) ? " graph-node-output" : "");
    parts.push(
      `<g class="${cls}" data-node-id="${esc(n.id)}">` +
      `<rect x="${p.x}" y="${p.y}" width="${NODE_W}" height="${NODE_H}" ` +
      `rx="6"/>` +
      `<text class="graph-title" x="${p.x + 8}" y="${p.y + 18}">` +
      `${esc(n.id)} · ${esc(n.classType)}</text>` +
      `<text class="graph-params" x="${p.x + 8}" y="${p.y + 38}">` +
      `${esc(paramSummary(n.params))}</text>` +
      `</g>`);
  }
  parts.push("</svg>");
  return parts.join("");
}

// convenience used by main.js: textarea text → SVG (or a short message
// for empty/invalid JSON)
export function graphSvgFromText(text, outputClasses = new Set()) {
  if (!text || !text.trim()) return "";
  let prompt;
  try {
    prompt = JSON.parse(text);
  } catch {
    return "";                    // the lint panel already reports errors
  }
  const model = graphModel(prompt);
  if (!model.nodes.length) return "";
  return renderGraphSvg(model, outputClasses);
}
