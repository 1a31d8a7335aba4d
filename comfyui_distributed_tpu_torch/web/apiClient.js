// Typed fetch client for the /distributed/* control plane with
// retry/backoff (parity: reference web/apiClient.js — retry x3 with
// backoff, web/apiClient.js:10-47; route coverage per SURVEY §2.6).

const RETRIES = 3;
const BACKOFF_MS = 400;
const AUTH_STORAGE_KEY = "cdt_auth_token";

// Cluster auth token (utils/auth.py): mutating routes 401 without it once
// a token is configured (a public tunnel auto-generates one). The user
// pastes it into the dashboard settings; persisted in localStorage.
export function getAuthToken() {
  try { return localStorage.getItem(AUTH_STORAGE_KEY) || ""; } catch { return ""; }
}

export function setAuthToken(token) {
  try {
    if (token) localStorage.setItem(AUTH_STORAGE_KEY, token);
    else localStorage.removeItem(AUTH_STORAGE_KEY);
  } catch { /* storage unavailable (private mode) — header still unset */ }
}

function buildHeaders(method) {
  const headers = {};
  // POSTs always declare JSON: the control plane rejects POSTs without a
  // JSON content type (cross-origin simple-request guard)
  if (method === "POST") headers["Content-Type"] = "application/json";
  const token = getAuthToken();
  if (token) headers["X-CDT-Auth"] = token;
  return Object.keys(headers).length ? headers : undefined;
}

async function request(path, { method = "GET", body, retries = RETRIES, timeoutMs = 15000 } = {}) {
  let lastErr;
  for (let attempt = 0; attempt <= retries; attempt++) {
    const ctrl = new AbortController();
    const timer = setTimeout(() => ctrl.abort(), timeoutMs);
    try {
      const resp = await fetch(path, {
        method,
        headers: buildHeaders(method),
        body: body !== undefined ? JSON.stringify(body) : undefined,
        signal: ctrl.signal,
      });
      clearTimeout(timer);
      const text = await resp.text();
      let data = null;
      try { data = text ? JSON.parse(text) : null; } catch { data = { raw: text }; }
      if (!resp.ok) {
        const err = new Error((data && data.error) || `HTTP ${resp.status}`);
        err.status = resp.status;
        err.data = data;
        // client errors are final; only retry transport/5xx
        if (resp.status < 500) throw err;
        lastErr = err;
      } else {
        return data;
      }
    } catch (e) {
      clearTimeout(timer);
      if (e.status && e.status < 500) throw e;
      lastErr = e;
    }
    if (attempt < retries) {
      await new Promise((r) => setTimeout(r, BACKOFF_MS * 2 ** attempt));
    }
  }
  throw lastErr;
}

export const api = {
  // health / info
  health: () => request("/distributed/health", { retries: 0, timeoutMs: 4000 }),
  systemInfo: () => request("/distributed/system_info"),
  networkInfo: () => request("/distributed/network_info"),

  // config
  getConfig: () => request("/distributed/config"),
  updateWorker: (worker) => request("/distributed/config/update_worker", { method: "POST", body: worker }),
  deleteWorker: (workerId) => request("/distributed/config/delete_worker", { method: "POST", body: { id: workerId } }),
  updateSetting: (key, value) => request("/distributed/config/update_setting", { method: "POST", body: { key, value } }),
  updateMaster: (fields) => request("/distributed/config/update_master", { method: "POST", body: fields }),
  autoPopulate: () => request("/distributed/config/auto_populate", { method: "POST", body: {}, retries: 0 }),

  // queue
  queue: (prompt, opts = {}) => request("/distributed/queue", {
    method: "POST",
    body: { prompt, ...opts },
    timeoutMs: 120000,
    retries: 0,
  }),
  clearMemory: () => request("/distributed/clear_memory", { method: "POST", body: {} }),
  interrupt: () => request("/distributed/interrupt", { method: "POST", body: {}, retries: 0 }),

  // worker processes
  launchWorker: (workerId) => request("/distributed/launch_worker", { method: "POST", body: { worker_id: workerId }, retries: 0, timeoutMs: 60000 }),
  stopWorker: (workerId) => request("/distributed/stop_worker", { method: "POST", body: { worker_id: workerId }, retries: 0 }),
  managedWorkers: () => request("/distributed/managed_workers"),
  workerLog: (workerId) => request(`/distributed/worker_log/${encodeURIComponent(workerId)}`),
  remoteWorkerLog: (workerId) => request(`/distributed/remote_worker_log/${encodeURIComponent(workerId)}`),
  localLog: () => request("/distributed/local_log"),
  localWorkerStatus: () => request("/distributed/local-worker-status"),
  clearLaunching: (workerId) => request("/distributed/worker/clear_launching", { method: "POST", body: { worker_id: workerId } }),

  // node interface specs (drives the workflow parameter forms)
  objectInfo: () => request("/distributed/object_info"),

  // shipped workflows
  listWorkflows: () => request("/distributed/workflows"),
  getWorkflow: (name) => request(`/distributed/workflows/${encodeURIComponent(name)}`),

  // observability
  memoryStats: () => request("/distributed/memory_stats"),
  stepTimes: () => request("/distributed/step_times"),
  metrics: () => request("/distributed/metrics.json", { retries: 0 }),
  trace: (jobId) => request(`/distributed/trace/${encodeURIComponent(jobId)}`, { retries: 0 }),
  progress: (promptId) => request(`/distributed/progress/${encodeURIComponent(promptId)}`, { retries: 0 }),
  previewUrl: (promptId, shard = 0) => `/distributed/preview/${encodeURIComponent(promptId)}?shard=${shard}&t=${Date.now()}`,
  profileStart: (out) => request("/distributed/profile/start", { method: "POST", body: out ? { out } : {}, retries: 0 }),
  profileStop: () => request("/distributed/profile/stop", { method: "POST", body: {}, retries: 0 }),

  // tunnel
  tunnelStatus: () => request("/distributed/tunnel/status"),
  tunnelStart: () => request("/distributed/tunnel/start", { method: "POST", body: {}, retries: 0, timeoutMs: 45000 }),
  tunnelStop: () => request("/distributed/tunnel/stop", { method: "POST", body: {}, retries: 0 }),
};

// Probe a worker host directly from the browser (parity: the UI's
// pre-flight probe, web/executionUtils.js:108-151). Cross-origin — the
// controller enables CORS on /distributed/health.
export async function probeHost(address, timeoutMs = 4000) {
  const base = normalizeAddress(address);
  const ctrl = new AbortController();
  const timer = setTimeout(() => ctrl.abort(), timeoutMs);
  try {
    const resp = await fetch(`${base}/distributed/health`, { signal: ctrl.signal });
    clearTimeout(timer);
    return resp.ok ? await resp.json() : null;
  } catch {
    clearTimeout(timer);
    return null;
  }
}

// URL normalization (parity: reference web/urlUtils.js — https heuristics
// for cloud domains).
const HTTPS_DOMAINS = ["trycloudflare.com", "ngrok.io", "ngrok-free.app", "proxy.runpod.net"];

export function normalizeAddress(address) {
  let a = String(address || "").trim().replace(/\/+$/, "");
  if (!a) return "";
  if (!a.includes("://")) {
    const https = HTTPS_DOMAINS.some((d) => a.includes(d));
    a = `${https ? "https" : "http"}://${a}`;
  }
  if (a.startsWith("http://") && HTTPS_DOMAINS.some((d) => a.includes(d))) {
    a = "https://" + a.slice("http://".length);
  }
  return a;
}
