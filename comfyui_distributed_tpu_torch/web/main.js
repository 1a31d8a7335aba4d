// Dashboard controller (parity: reference web/main.js DistributedExtension
// + workerLifecycle.js status polling + workerSettings.js CRUD +
// tunnelManager.js — SURVEY §2.7), dependency-free.

import { api, probeHost, normalizeAddress, getAuthToken, setAuthToken } from "./apiClient.js";
import { clampDivideBy, dividerNodes, inactiveLinks, describeAddedHosts, MAX_DIVIDE } from "./widgets.js";
import { editableFields, groupByNode, applyFieldEdit, isMultiline, lintPrompt } from "./forms.js";
import { distributedValueNodes, hostsWithConfigIndex, workerKey, parseWorkerValues,
         valueType, setWorkerValue, serializeWorkerValues, orphanedKeys } from "./valueWidgets.js";
import { newPollState, pollTick } from "./progressLogic.js";
import { graphSvgFromText } from "./graphView.js";
import { telemetryRows } from "./telemetryLogic.js";

const POLL_MS = 3000;
const LOG_REFRESH_MS = 2000;

const state = {
  config: null,
  status: new Map(),       // worker_id → {online, queue_remaining, launching}
  managed: {},             // worker_id → {pid, log}
  logTimer: null,
  editingId: null,
  nodeSpecs: null,         // /distributed/object_info → parameter forms
};

const $ = (id) => document.getElementById(id);

// circuit-breaker suffix for the worker-card meta line; closed (healthy)
// stays silent — only a quarantined or probing breaker is news
function breakerBadge(state) {
  if (state === "open") return " · ⛔ breaker open";
  if (state === "half_open") return " · ⚠ breaker half-open";
  return "";
}

// AOT warmup suffix (diffusion/warmup.py): only a still-compiling worker
// is news — ready/cold/legacy probes stay silent, matching the
// dispatcher's hot-host preference (cluster/dispatch.py is_hot)
function warmupBadge(state) {
  if (state === "warming") return " · 🔥 warming";
  if (state === "error") return " · ⚠ warmup failed";
  return "";
}

// Lifecycle suffix (cluster/elastic): a draining/decommissioned worker
// is leaving ON PURPOSE — badged distinctly from a broken one so an
// operator never mistakes a scale-down for an outage
function drainBadge(state) {
  if (state === "draining") return " · 🪫 draining";
  if (state === "decommissioned") return " · 🚪 decommissioned";
  return "";
}

// ---------------------------------------------------------------------------
// worker cards
// ---------------------------------------------------------------------------

function workerCard(worker) {
  const st = state.status.get(worker.id) || {};
  const managed = state.managed[worker.id];
  const card = document.createElement("div");
  card.className = "worker-card" + (worker.enabled ? "" : " disabled");

  const dot = document.createElement("span");
  // an open breaker (cluster/resilience.py) outranks the probe verdict:
  // the host is quarantined — orchestration won't even probe it
  dot.className = "dot " + (st.breaker === "open" ? "offline"
    : st.launching ? "launching"
    : st.online ? (st.queue_remaining > 0 ? "busy" : "online") : "offline");
  dot.title = st.breaker === "open" ? "breaker open (quarantined)"
    : st.online ? `queue: ${st.queue_remaining ?? 0}` : "offline";

  const info = document.createElement("div");
  info.className = "info";
  const qr = st.online && st.queue_remaining > 0 ? ` — queue ${st.queue_remaining}` : "";
  const breaker = breakerBadge(st.breaker);
  info.innerHTML = `
    <div class="name"></div>
    <div class="addr"></div>
    <div class="meta"></div>`;
  info.querySelector(".name").textContent = worker.name || worker.id;
  info.querySelector(".addr").textContent = worker.address;
  info.querySelector(".meta").textContent =
    `${worker.type || "auto"}${managed ? ` · pid ${managed.pid}` : ""}` +
    `${st.online ? " · online" + qr : " · offline"}` + breaker +
    warmupBadge(st.warmup) + drainBadge(st.drain);

  const toggle = document.createElement("input");
  toggle.type = "checkbox";
  toggle.checked = !!worker.enabled;
  toggle.title = "enabled";
  toggle.onchange = async () => {
    await api.updateWorker({ ...worker, enabled: toggle.checked });
    await refreshConfig();
  };

  const buttons = document.createElement("div");
  buttons.className = "row";
  const mkBtn = (label, cls, fn, title = "") => {
    const b = document.createElement("button");
    b.textContent = label;
    b.className = cls;
    b.title = title;
    b.onclick = fn;
    buttons.appendChild(b);
    return b;
  };
  if (managed) {
    mkBtn("Stop", "small ghost danger", async () => {
      await api.stopWorker(worker.id).catch(alertError);
      await refreshManaged();
      renderWorkers();
    });
    mkBtn("Log", "small ghost", () => openLog(worker.id));
  } else if ((worker.type || "local") === "remote") {
    // remote controller: proxy its in-memory log through the master
    // (reference remote_worker_log, api/worker_routes.py:649-695)
    mkBtn("Log", "small ghost", () => openLog(worker.id, true));
  } else {
    mkBtn("Launch", "small ghost", async (ev) => {
      ev.target.disabled = true;
      state.status.set(worker.id, { ...st, launching: true });
      renderWorkers();
      try { await api.launchWorker(worker.id); } catch (e) { alertError(e); }
      await refreshManaged();
      renderWorkers();
    });
  }
  mkBtn("Edit", "small ghost", () => openEditor(worker));
  mkBtn("✕", "small ghost danger", async () => {
    if (!confirm(`Delete host ${worker.id}?`)) return;
    await api.deleteWorker(worker.id).catch(alertError);
    await refreshConfig();
  }, "delete");

  card.append(dot, info, toggle, buttons);
  return card;
}

function renderWorkers() {
  const root = $("worker-cards");
  root.replaceChildren();
  const hosts = (state.config && state.config.hosts) || [];
  if (!hosts.length) {
    const p = document.createElement("p");
    p.className = "meta";
    p.textContent = "No worker hosts configured — add one, or launch " +
      "additional controllers on other hosts or cards.";
    root.appendChild(p);
    return;
  }
  for (const w of hosts) root.appendChild(workerCard(w));
}

// ---------------------------------------------------------------------------
// polling (parity: workerLifecycle.js status loop)
// ---------------------------------------------------------------------------

async function pollStatus() {
  const hosts = (state.config && state.config.hosts) || [];
  // server-side launching-state machine: flags set at launch, cleared by
  // the worker's clear_launching self-report (reference workerLifecycle.js
  // launching-flag tracking)
  let serverStatus = {};
  try {
    serverStatus = (await api.localWorkerStatus()).workers || {};
  } catch { /* older controller: browser probes only */ }
  await Promise.all(hosts.map(async (w) => {
    const prev = state.status.get(w.id) || {};
    const srv = serverStatus[w.id];
    if (srv && srv.online !== undefined && w.id in serverStatus) {
      // server already probed this (local/managed) host — don't probe twice
      state.status.set(w.id, {
        online: !!srv.online,
        queue_remaining: srv.queue_remaining,
        launching: srv.launching || (prev.launching && !srv.online),
        breaker: srv.breaker,
      });
      return;
    }
    const health = await probeHost(w.address);
    state.status.set(w.id, {
      online: !!health,
      queue_remaining: health ? health.queue_remaining : null,
      launching: prev.launching && !health,
    });
  }));
  try {
    const h = await api.health();
    $("master-dot").className = "dot " + (h.queue_remaining > 0 ? "busy" : "online");
    $("master-label").textContent = `master · ${h.machine_id}` +
      (h.queue_remaining ? ` · queue ${h.queue_remaining}` : "");
  } catch {
    $("master-dot").className = "dot offline";
  }
  renderWorkers();
}

async function refreshConfig() {
  try {
    state.config = await api.getConfig();
  } catch (e) {
    // 401 = auth token configured but not supplied (or wrong): the
    // dashboard must still render the settings panel so the user can
    // paste the token — otherwise a tunnel-protected deployment bricks
    // its own recovery path.
    state.config = null;
    renderSettings();
    if (e && e.status === 401) {
      const root = $("worker-cards");
      root.replaceChildren();
      const note = document.createElement("div");
      note.className = "muted";
      note.textContent =
        "This cluster requires an auth token — paste it under Settings.";
      root.append(note);
      return;
    }
    throw e;
  }
  renderWorkers();
  renderSettings();
  renderMesh();
  renderNodeWidgets();
  renderParamForms();
  renderGraphView();
}

async function refreshManaged() {
  try {
    const res = await api.managedWorkers();
    state.managed = res.workers || {};
  } catch { state.managed = {}; }
}

// ---------------------------------------------------------------------------
// mesh / device info
// ---------------------------------------------------------------------------

async function renderMesh() {
  const root = $("mesh-info");
  root.replaceChildren();
  try {
    const info = await api.systemInfo();
    // degraded payload (device backend unresponsive): entries carry an
    // `error` field instead of a device census — surface it, don't
    // render "1 — undefined"
    const devErr = (info.devices || []).find((d) => d.error);
    const rows = [
      ["Platform", `${info.platform} (torch ${info.torch || "?"}, CUDA ${info.cuda || "none"})`],
      ["Devices", devErr ? `⚠ ${devErr.error}` :
        String((info.devices || []).length) + " — " +
        [...new Set((info.devices || []).map((d) => d.kind))].join(", ")],
      ["Mesh shape", JSON.stringify((state.config || {}).mesh?.shape || {})],
      ["Machine", info.machine_id],
    ];
    for (const [k, v] of rows) {
      const kd = document.createElement("div"); kd.className = "k"; kd.textContent = k;
      const vd = document.createElement("div"); vd.textContent = v;
      root.append(kd, vd);
    }
  } catch (e) {
    root.textContent = "system info unavailable: " + e.message;
  }
}

// ---------------------------------------------------------------------------
// telemetry panel (/distributed/metrics.json — docs/telemetry.md)
// ---------------------------------------------------------------------------

async function renderTelemetry() {
  const root = $("telemetry-info");
  let rows;
  try {
    const res = await api.metrics();
    rows = telemetryRows((res && res.metrics) || {});
  } catch (e) {
    root.textContent = "telemetry unavailable: " + e.message;
    return;
  }
  root.replaceChildren();
  for (const [k, v] of rows) {
    const kd = document.createElement("div"); kd.className = "k"; kd.textContent = k;
    const vd = document.createElement("div"); vd.textContent = v;
    root.append(kd, vd);
  }
}

// ---------------------------------------------------------------------------
// settings (parity: sidebar settings section)
// ---------------------------------------------------------------------------

const SETTING_FIELDS = [
  ["debug", "checkbox", "Debug logging"],
  ["auto_launch_workers", "checkbox", "Auto-launch local workers on start"],
  ["stop_workers_on_master_exit", "checkbox", "Stop workers on master exit"],
  ["master_delegate_only", "checkbox", "Master delegates only (no compute)"],
  ["worker_timeout_seconds", "number", "Worker timeout (s)"],
  ["worker_probe_concurrency", "number", "Probe concurrency"],
  ["media_sync_concurrency", "number", "Media sync concurrency"],
];

function renderSettings() {
  const root = $("settings-form");
  root.replaceChildren();
  const settings = (state.config && state.config.settings) || {};
  for (const [key, kind, label] of SETTING_FIELDS) {
    const kd = document.createElement("div");
    kd.className = "k";
    kd.textContent = label;
    const input = document.createElement("input");
    input.type = kind;
    if (kind === "checkbox") input.checked = !!settings[key];
    else input.value = settings[key] ?? "";
    input.onchange = async () => {
      const value = kind === "checkbox" ? input.checked : Number(input.value);
      try { await api.updateSetting(key, value); } catch (e) { alertError(e); }
    };
    root.append(kd, input);
  }
  // cluster auth token: stored browser-side only (localStorage) and sent
  // as X-CDT-Auth on every API call — never written into the config via
  // this field (the server already knows it)
  const kd = document.createElement("div");
  kd.className = "k";
  kd.textContent = "Auth token (X-CDT-Auth)";
  const input = document.createElement("input");
  input.type = "password";
  input.placeholder = "paste cluster token";
  input.autocomplete = "off";
  input.value = getAuthToken();
  input.onchange = () => { setAuthToken(input.value.trim()); refreshConfig(); };
  root.append(kd, input);
}

// ---------------------------------------------------------------------------
// queue form (parity: executionUtils.js preflight + POST /distributed/queue)
// ---------------------------------------------------------------------------

async function submitQueue(ev) {
  ev.preventDefault();
  const result = $("queue-result");
  result.hidden = false;
  let prompt;
  try {
    prompt = JSON.parse($("queue-prompt").value);
  } catch (e) {
    result.textContent = "Invalid JSON: " + e.message;
    return;
  }
  result.textContent = "Pre-flight probing workers…";
  const hosts = ((state.config || {}).hosts || []).filter((w) => w.enabled);
  const probes = await Promise.all(hosts.map((w) => probeHost(w.address)));
  const online = hosts.filter((_, i) => probes[i]);
  result.textContent = `Dispatching (${online.length}/${hosts.length} workers online)…`;
  try {
    const res = await api.queue(prompt, {
      load_balance: $("queue-loadbalance").checked,
      delegate_master: $("queue-delegate").checked,
    });
    result.textContent = JSON.stringify(res, null, 2);
    if (res.prompt_id) trackProgress(res.prompt_id);
  } catch (e) {
    result.textContent = "Error: " + e.message +
      (e.data ? "\n" + JSON.stringify(e.data, null, 2) : "");
  }
}

// live sampling progress + latent preview (/distributed/progress|preview —
// the step/preview UX ComfyUI's UI provides, served by our own tracker)
let progressTimer = null;
async function trackProgress(promptId) {
  const box = $("job-progress"), bar = $("job-progress-bar");
  const label = $("job-progress-label"), img = $("job-preview");
  if (progressTimer) clearInterval(progressTimer);
  box.hidden = false;
  bar.style.width = "0%";
  label.textContent = "waiting for first step…";
  img.hidden = true;
  const poll = newPollState();     // state machine in progressLogic.js
  progressTimer = setInterval(async () => {
    let snap = null;
    try { snap = await api.progress(promptId); } catch { /* counted as miss */ }
    const tick = pollTick(poll, snap);
    if (tick.label) label.textContent = tick.label;
    if (tick.widthPct !== null) bar.style.width = tick.widthPct + "%";
    if (tick.refetchPreview) {
      img.src = api.previewUrl(promptId);
      img.hidden = false;
    }
    if (tick.hide) box.hidden = true;
    if (tick.stop) clearInterval(progressTimer);
  }, 750);
}

// ---------------------------------------------------------------------------
// per-node widget layer (parity: reference web/distributedValue.js — per-
// worker value widgets for DistributedValue nodes, two-way synced with the
// prompt JSON's `worker_values` map; keys are 1-indexed worker numbers,
// nodes/utilities.py:86-162)
// ---------------------------------------------------------------------------

function parsePrompt() {
  try { return JSON.parse($("queue-prompt").value); } catch { return null; }
}

function writePromptInput(nodeId, field, value) {
  const prompt = parsePrompt();
  if (!prompt || !prompt[nodeId]) return;
  prompt[nodeId].inputs = prompt[nodeId].inputs || {};
  prompt[nodeId].inputs[field] = value;
  $("queue-prompt").value = JSON.stringify(prompt, null, 2);
  // programmatic value assignment fires no "input" event — keep the
  // graph view in sync with every edit path ("the graph a user sees is
  // the graph that will be queued", docs/api.md)
  renderGraphView();
}

// Read-only DAG render of the loaded workflow (graphView.js): the user
// SEES the graph they are queueing — nodes, links, parameter summaries,
// output nodes highlighted (the reference shows this via ComfyUI's
// canvas; VERDICT r4 next #6).
function renderGraphView() {
  const root = $("graph-panel");
  const outputClasses = new Set();
  for (const [name, spec] of Object.entries((state.nodeSpecs || {}).nodes || {})) {
    if (spec.output_node) outputClasses.add(name);
  }
  const svg = graphSvgFromText($("queue-prompt").value, outputClasses);
  root.innerHTML = svg;
  root.hidden = !svg;
}

// Parameter forms generated from node interface specs (forms.js +
// /distributed/object_info): edit prompt/seed/size/steps without touching
// the raw JSON (VERDICT r3 next #3; the reference gets this from
// ComfyUI's graph editor, web/executionUtils.js:6-23).
function renderParamForms() {
  const root = $("param-forms");
  root.replaceChildren();
  const prompt = parsePrompt();
  const fields = editableFields(prompt, state.nodeSpecs);
  const issues = lintPrompt(prompt, state.nodeSpecs);
  if (!fields.length && !issues.length) {
    root.hidden = true;
    return;
  }
  root.hidden = false;
  // preflight lint (mirrors the server's validate_prompt, so the user
  // sees the node_errors BEFORE queueing)
  for (const issue of issues) {
    const div = document.createElement("div");
    div.className = issue.level === "error" ? "error" : "meta";
    div.textContent =
      `${issue.level === "error" ? "✕" : "⚠"} node #${issue.nodeId}: ` +
      issue.message;
    root.appendChild(div);
  }
  if (!fields.length) return;
  const head = document.createElement("div");
  head.className = "meta";
  head.textContent = "Parameters (writes through to the JSON above)";
  root.appendChild(head);
  for (const group of groupByNode(fields)) {
    const box = document.createElement("div");
    box.className = "dv-node";
    const title = document.createElement("div");
    title.className = "meta";
    title.textContent = `${group.classType} #${group.nodeId}`;
    const grid = document.createElement("div");
    grid.className = "kv";
    for (const f of group.fields) {
      const kd = document.createElement("div");
      kd.className = "k";
      kd.textContent = f.name + (f.optional ? "" : " *");
      let input;
      if (f.kind === "boolean") {
        input = document.createElement("input");
        input.type = "checkbox";
        input.checked = !!f.value;
      } else if (isMultiline(f)) {
        input = document.createElement("textarea");
        input.rows = 2;
        input.value = f.value ?? "";
      } else {
        input = document.createElement("input");
        if (f.kind === "int" || f.kind === "float") {
          input.type = "number";
          if (f.kind === "float") input.step = "any";
        }
        input.value = f.value ?? "";
      }
      input.onchange = () => {
        const prompt = parsePrompt();
        if (!prompt) return;
        try {
          const raw = f.kind === "boolean" ? input.checked : input.value;
          const coerced = applyFieldEdit(prompt, f.nodeId, f.name, f.kind, raw);
          $("queue-prompt").value = JSON.stringify(prompt, null, 2);
          renderGraphView();   // form edits fire no "input" event
          if (f.kind !== "boolean") input.value = coerced;
          input.classList.remove("invalid");
        } catch (e) {
          input.classList.add("invalid");
          input.title = e.message;
        }
      };
      grid.append(kd, input);
    }
    box.append(title, grid);
    root.appendChild(box);
  }
}

function renderNodeWidgets() {
  const root = $("node-widgets");
  root.replaceChildren();
  const prompt = parsePrompt();
  // worker_values keys are 1-indexed positions in the FULL config host
  // list (the orchestrator's stable worker_index contract) — enabled
  // hosts are shown, but each keeps its config-position number
  // (valueWidgets.js carries the pure logic + its node:test suite)
  const hosts = hostsWithConfigIndex(state.config);
  const dvNodes = distributedValueNodes(prompt);
  const divNodes = dividerNodes(prompt);
  if ((!dvNodes.length || !hosts.length) && !divNodes.length) {
    root.hidden = true;
    return;
  }
  root.hidden = false;

  // divider dynamic outputs (parity: web/image_batch_divider.js:10-62 —
  // there the node canvas grows/shrinks outputs; here the widget sets
  // divide_by and flags links into chunks the new count deactivates)
  for (const [nodeId, node] of divNodes) {
    const inputs = node.inputs || {};
    const box = document.createElement("div");
    box.className = "dv-node";
    const title = document.createElement("div");
    title.className = "meta";
    title.textContent = `${node.class_type} #${nodeId}`;
    const grid = document.createElement("div");
    grid.className = "kv";
    const kd = document.createElement("div");
    kd.className = "k";
    kd.textContent = "divide_by (active outputs)";
    const input = document.createElement("input");
    input.type = "number";
    input.min = "1";
    input.max = String(MAX_DIVIDE);
    input.value = clampDivideBy(inputs.divide_by ?? 2);
    const warn = document.createElement("div");
    warn.className = "meta";
    const refreshWarn = (val) => {
      const stale = inactiveLinks(parsePrompt(), nodeId, val);
      warn.textContent = stale.length
        ? `⚠ ${stale.map((s) => `#${s.consumerId}.${s.inputName} uses ` +
            `output ${s.outputIndex}`).join("; ")} — beyond divide_by, ` +
          "will receive an empty batch"
        : "";
    };
    input.onchange = () => {
      const val = clampDivideBy(input.value);
      input.value = val;
      writePromptInput(nodeId, "divide_by", val);
      refreshWarn(val);
    };
    refreshWarn(clampDivideBy(inputs.divide_by ?? 2));
    grid.append(kd, input);
    box.append(title, grid, warn);
    root.appendChild(box);
  }
  if (!dvNodes.length || !hosts.length) return;
  for (const [nodeId, node] of dvNodes) {
    const inputs = node.inputs || {};
    const mapping = parseWorkerValues(inputs.worker_values);
    const vtype = valueType(inputs, mapping);

    const box = document.createElement("div");
    box.className = "dv-node";
    const title = document.createElement("div");
    title.className = "meta";
    const dflt = Array.isArray(inputs.default_value)
      ? `link ${JSON.stringify(inputs.default_value)}`
      : JSON.stringify(inputs.default_value ?? null);
    title.textContent =
      `DistributedValue #${nodeId}${vtype ? ` (${vtype})` : ""} — default ${dflt}`;
    box.appendChild(title);

    const orphans = orphanedKeys(mapping, state.config);
    if (orphans.length) {
      const warn = document.createElement("div");
      warn.className = "meta";
      warn.textContent = `⚠ worker_values keys beyond the host list ` +
        `(never read): ${orphans.join(", ")}`;
      box.appendChild(warn);
    }

    const grid = document.createElement("div");
    grid.className = "kv";
    hosts.forEach(([w, configIdx]) => {
      const key = workerKey(configIdx);
      const kd = document.createElement("div");
      kd.className = "k";
      kd.textContent = `${w.name || w.id} (#${key})`;
      const input = document.createElement("input");
      if (vtype === "INT" || vtype === "FLOAT") input.type = "number";
      input.value = mapping[key] ?? "";
      input.placeholder = "(default)";
      input.onchange = () => {
        try {
          setWorkerValue(mapping, key, input.value, vtype);
          input.classList.remove("invalid");
        } catch (e) {
          input.classList.add("invalid");
          input.title = e.message;
          return;
        }
        writePromptInput(nodeId, "worker_values",
                         serializeWorkerValues(mapping));
      };
      grid.append(kd, input);
    });
    box.appendChild(grid);
    root.appendChild(box);
  }
}

// ---------------------------------------------------------------------------
// log modal (parity: workerLifecycle.js log modal, 2s auto-refresh)
// ---------------------------------------------------------------------------

async function fetchLog(workerId, remote) {
  const res = workerId === "__local__" ? await api.localLog()
    : remote ? await api.remoteWorkerLog(workerId)
    : await api.workerLog(workerId);
  return res.log || res.raw || "";
}

function openLog(workerId, remote = false) {
  $("log-title").textContent = workerId === "__local__"
    ? "Controller log"
    : `Worker ${workerId} log${remote ? " (remote)" : ""}`;
  $("modal-backdrop").hidden = false;
  const body = $("log-body");
  const refresh = async () => {
    try {
      body.textContent = await fetchLog(workerId, remote);
      if ($("log-follow").checked) body.scrollTop = body.scrollHeight;
    } catch (e) {
      body.textContent = "log unavailable: " + e.message;
    }
  };
  refresh();
  state.logTimer = setInterval(refresh, LOG_REFRESH_MS);
}

function closeLog() {
  $("modal-backdrop").hidden = true;
  clearInterval(state.logTimer);
}

// ---------------------------------------------------------------------------
// worker editor (parity: workerSettings.js forms)
// ---------------------------------------------------------------------------

function openEditor(worker) {
  state.editingId = worker ? worker.id : null;
  $("editor-title").textContent = worker ? `Edit ${worker.id}` : "Add host";
  $("ed-id").value = worker?.id || "";
  $("ed-id").disabled = !!worker;
  $("ed-name").value = worker?.name || "";
  $("ed-address").value = worker?.address || "";
  $("ed-type").value = worker?.type || "";
  $("ed-mesh").value = worker?.mesh_devices ?? -1;
  $("ed-extra").value = worker?.extra_args || "";
  $("ed-enabled").checked = worker ? !!worker.enabled : true;
  $("editor-backdrop").hidden = false;
}

async function saveEditor(ev) {
  ev.preventDefault();
  const worker = {
    id: $("ed-id").value.trim(),
    name: $("ed-name").value.trim(),
    address: normalizeAddress($("ed-address").value),
    enabled: $("ed-enabled").checked,
    mesh_devices: Number($("ed-mesh").value),
    extra_args: $("ed-extra").value,
  };
  const type = $("ed-type").value;
  if (type) worker.type = type;
  try {
    await api.updateWorker(worker);
    $("editor-backdrop").hidden = true;
    await refreshConfig();
  } catch (e) { alertError(e); }
}

// ---------------------------------------------------------------------------
// tunnel (parity: tunnelManager.js)
// ---------------------------------------------------------------------------

async function refreshTunnel() {
  try {
    const st = await api.tunnelStatus();
    $("tunnel-dot").className = "dot " + (st.running ? "online" : "");
    $("tunnel-url").textContent = st.running ? st.url : "stopped";
    $("btn-tunnel").textContent = st.running ? "Stop tunnel" : "Start tunnel";
    $("btn-tunnel").dataset.running = st.running ? "1" : "";
    $("tunnel-error").hidden = true;
  } catch { /* section stays as-is */ }
}

async function toggleTunnel() {
  const btn = $("btn-tunnel");
  btn.disabled = true;
  try {
    if (btn.dataset.running) await api.tunnelStop();
    else await api.tunnelStart();
  } catch (e) {
    $("tunnel-error").textContent = e.message;
    $("tunnel-error").hidden = false;
  }
  btn.disabled = false;
  await refreshTunnel();
}

// ---------------------------------------------------------------------------

function alertError(e) {
  console.error(e);
  alert(e.message || String(e));
}

async function loadWorkflowList() {
  try {
    const res = await api.listWorkflows();
    const sel = $("workflow-select");
    for (const name of res.workflows || []) {
      const opt = document.createElement("option");
      opt.value = name;
      opt.textContent = name;
      sel.appendChild(opt);
    }
  } catch { /* route absent on older controllers */ }
}

async function init() {
  $("queue-form").onsubmit = submitQueue;
  $("btn-load-workflow").onclick = async () => {
    const name = $("workflow-select").value;
    if (!name) return;
    try {
      const wf = await api.getWorkflow(name);
      delete wf._meta;
      $("queue-prompt").value = JSON.stringify(wf, null, 2);
      renderNodeWidgets();
      renderParamForms();
      renderGraphView();
    } catch (e) { alertError(e); }
  };
  let widgetDebounce = null;
  $("queue-prompt").addEventListener("input", () => {
    clearTimeout(widgetDebounce);
    widgetDebounce = setTimeout(() => {
      renderNodeWidgets();
      renderParamForms();
      renderGraphView();
    }, 400);
  });
  $("btn-add-worker").onclick = () => openEditor(null);
  $("btn-auto-populate").onclick = async () => {
    // device census → worker rows (reference masterDetection.js:36-100)
    try {
      const res = await api.autoPopulate();
      alert(res.added && res.added.length
        ? `Added: ${describeAddedHosts(res)}`
        : "No new slice hosts found (census advertises none beyond this host)");
      await refreshConfig();
    } catch (e) { alertError(e); }
  };
  $("editor-cancel").onclick = () => { $("editor-backdrop").hidden = true; };
  $("editor-form").onsubmit = saveEditor;
  $("log-close").onclick = closeLog;
  $("modal-backdrop").onclick = (ev) => {
    if (ev.target === $("modal-backdrop")) closeLog();
  };
  $("btn-tunnel").onclick = toggleTunnel;
  $("btn-interrupt").onclick = async () => {
    // fan out to all enabled hosts, then the master (reference
    // workerUtils.js:73-95)
    const hosts = ((state.config || {}).hosts || []).filter((w) => w.enabled);
    await Promise.all(hosts.map((w) =>
      fetch(`${normalizeAddress(w.address)}/distributed/interrupt`,
            { method: "POST" }).catch(() => null)));
    await api.interrupt().catch(alertError);
  };
  $("btn-clear-memory").onclick = async () => {
    const hosts = ((state.config || {}).hosts || []).filter((w) => w.enabled);
    await Promise.all(hosts.map((w) =>
      fetch(`${normalizeAddress(w.address)}/distributed/clear_memory`,
            { method: "POST" }).catch(() => null)));
    await api.clearMemory().catch(alertError);
  };
  $("master-dot").ondblclick = () => openLog("__local__");

  // node interface specs for the parameter forms (one fetch; the
  // registry is static for the controller's lifetime)
  try { state.nodeSpecs = await api.objectInfo(); } catch { state.nodeSpecs = null; }

  await refreshConfig();
  await loadWorkflowList();
  await refreshManaged();
  await refreshTunnel();
  await pollStatus();
  await renderTelemetry();
  setInterval(pollStatus, POLL_MS);
  setInterval(refreshTunnel, POLL_MS * 4);
  setInterval(renderTelemetry, POLL_MS * 2);
}

init();
