// DistributedValue per-worker widget logic, DOM-free (extracted from
// main.js so node:test can cover it — VERDICT r3 next #8; parity:
// reference web/distributedValue.js:1-481, whose vitest suite covers the
// same coercion/resync/serialization surface).
//
// Contract (graph/nodes_builtin.py DistributedValue ←
// nodes/utilities.py:86-162): `worker_values` is a JSON object mapping
// 1-INDEXED positions in the FULL config host list to per-worker values;
// an optional `_type` key records the coercion type when any value is
// set. Enabled hosts are shown in the UI, but each keeps its
// config-position number — disabling host #1 must not renumber host #2.

export function distributedValueNodes(prompt) {
  if (!prompt || typeof prompt !== "object") return [];
  return Object.entries(prompt).filter(
    ([, n]) => n && n.class_type === "DistributedValue");
}

// [[host, configIndex], …] for enabled hosts, keeping full-list positions.
export function hostsWithConfigIndex(config) {
  return (((config || {}).hosts || []).map((w, i) => [w, i]))
    .filter(([w]) => w.enabled);
}

export function workerKey(configIndex) {
  return String(configIndex + 1);          // 1-indexed per reference
}

// inputs.worker_values (a JSON string) → mapping object; tolerant of
// missing/corrupt values (a hand-edited prompt must not brick the form).
export function parseWorkerValues(raw) {
  try {
    const m = JSON.parse(raw || "{}");
    return m && typeof m === "object" && !Array.isArray(m) ? m : {};
  } catch {
    return {};
  }
}

// The coercion type: explicit value_type input wins, else the mapping's
// recorded _type, else "" (opaque — values pass through as strings).
export function valueType(inputs, mapping) {
  return String((inputs && inputs.value_type) || (mapping && mapping._type)
    || "").toUpperCase();
}

export function coerceWorkerValue(vtype, raw) {
  if (vtype === "INT" || vtype === "FLOAT") {
    const n = Number(raw);
    // NaN would serialize as null and fail the job at execute time
    // (DistributedValue._coerce) — reject at the form instead
    if (!Number.isFinite(n) || (typeof raw === "string" && !raw.trim())) {
      throw new Error(`not a number: ${JSON.stringify(raw)}`);
    }
    if (vtype === "INT" && !Number.isInteger(n)) {
      throw new Error(`not an integer: ${JSON.stringify(raw)}`);
    }
    return n;
  }
  if (vtype === "BOOLEAN") {
    return raw === true || raw === "true" || raw === "1" || raw === 1;
  }
  return raw;
}

// Apply one per-worker edit: empty string clears the override (the worker
// falls back to default_value). Maintains the `_type` tag iff any real
// value remains. Mutates + returns the mapping.
export function setWorkerValue(mapping, key, raw, vtype) {
  if (raw === "" || raw === undefined || raw === null) delete mapping[key];
  else mapping[key] = coerceWorkerValue(vtype, raw);
  const hasValues = Object.keys(mapping).some((k) => k !== "_type");
  if (vtype && hasValues) mapping._type = vtype;
  else delete mapping._type;
  return mapping;
}

export function serializeWorkerValues(mapping) {
  return JSON.stringify(mapping);
}

// When the host set changes under a live form (auto-populate, delete),
// entries keyed beyond the config list are orphans the executor will
// never read — surfaced so the UI can warn instead of silently dropping.
export function orphanedKeys(mapping, config) {
  const hostCount = ((config || {}).hosts || []).length;
  return Object.keys(mapping || {}).filter((k) => {
    if (k === "_type") return false;
    const n = Number(k);
    return !Number.isInteger(n) || n < 1 || n > hostCount;
  });
}
