// Pure transforms of the /distributed/metrics.json snapshot for the
// dashboard's telemetry panel (node:test-covered in
// tests/telemetryLogic.test.mjs; main.js only renders the rows).
//
// The snapshot shape is telemetry/export.py's render_json():
//   { format: "cdt.metrics.v1", metrics: { name: {type, series: [...]}} }
// counters/gauges carry {labels, value}; histograms carry
// {labels, buckets: [[le, cumulative], ...], sum, count}.

function matches(labels, filter) {
  if (!filter) return true;
  return Object.entries(filter).every(([k, v]) => labels[k] === v);
}

// Sum a counter/gauge family's series, optionally filtered by labels.
export function seriesSum(metrics, name, labelFilter = null) {
  const fam = metrics && metrics[name];
  let total = 0;
  for (const s of (fam && fam.series) || []) {
    if (matches(s.labels || {}, labelFilter)) total += s.value || 0;
  }
  return total;
}

// Per-label-value totals of a counter family: { labelValue: sum }.
export function countsByLabel(metrics, name, label) {
  const fam = metrics && metrics[name];
  const out = {};
  for (const s of (fam && fam.series) || []) {
    const key = (s.labels || {})[label] ?? "";
    out[key] = (out[key] || 0) + (s.value || 0);
  }
  return out;
}

// Merge a histogram family's (optionally filtered) series into one
// {buckets, sum, count} — bucket bounds are fixed per family, so the
// cumulative counts add bucket-for-bucket.
export function mergeHistogram(metrics, name, labelFilter = null) {
  const fam = metrics && metrics[name];
  let merged = null;
  for (const s of (fam && fam.series) || []) {
    if (!matches(s.labels || {}, labelFilter)) continue;
    if (!merged) {
      merged = {
        buckets: s.buckets.map(([le, c]) => [le, c]),
        sum: s.sum,
        count: s.count,
      };
    } else {
      s.buckets.forEach(([, c], i) => { merged.buckets[i][1] += c; });
      merged.sum += s.sum;
      merged.count += s.count;
    }
  }
  return merged;
}

// q ∈ (0,1] → upper-bound estimate from cumulative buckets; null when the
// histogram is empty, Infinity when the quantile lands past the last
// finite bucket.
export function histQuantile(hist, q) {
  if (!hist || !hist.count) return null;
  const target = q * hist.count;
  for (const [le, cum] of hist.buckets) {
    if (cum >= target) return le;
  }
  return Infinity;
}

export function fmtSeconds(s) {
  if (s === null || s === undefined) return "—";
  if (s === Infinity) return ">max";
  if (s < 0.001) return `${(s * 1e6).toFixed(0)}µs`;
  if (s < 1) return `${(s * 1e3).toFixed(1)}ms`;
  return `${s.toFixed(2)}s`;
}

function fmtCounts(byLabel) {
  const parts = Object.entries(byLabel)
    .filter(([, v]) => v > 0)
    .map(([k, v]) => `${v} ${k}`);
  return parts.length ? parts.join(" · ") : "none";
}

// The panel's [label, value] rows, assembled from the standard families
// (telemetry/metrics.py). Tolerant of absent families — an older
// controller simply shows fewer rows.
export function telemetryRows(metrics) {
  const rows = [];
  rows.push(["Prompts", fmtCounts(
    countsByLabel(metrics, "cdt_prompts_total", "status"))]);
  const step = mergeHistogram(metrics, "cdt_sampler_step_seconds");
  rows.push(["Sampler step p50 / p95", step
    ? `${fmtSeconds(histQuantile(step, 0.5))} / ${fmtSeconds(histQuantile(step, 0.95))} (${step.count} obs)`
    : "no runs yet"]);
  rows.push(["Tile tasks", fmtCounts(
    countsByLabel(metrics, "cdt_tile_tasks_total", "event"))]);
  rows.push(["Tile queue depth",
    String(seriesSum(metrics, "cdt_tile_queue_depth"))]);
  const disp = mergeHistogram(metrics, "cdt_dispatch_seconds");
  rows.push(["Dispatches", disp && disp.count
    ? `${disp.count} · p95 ${fmtSeconds(histQuantile(disp, 0.95))}`
    : "none"]);
  rows.push(["Worker probes", fmtCounts(
    countsByLabel(metrics, "cdt_worker_probe_total", "outcome"))]);
  rows.push(["Circuit breakers", breakerSummary(metrics)]);
  const retries = seriesSum(metrics, "cdt_retry_attempts_total");
  if (retries > 0) rows.push(["Retries", String(retries)]);
  rows.push(["Front door", frontDoorSummary(metrics)]);
  rows.push(["Stages", stagesSummary(metrics)]);
  rows.push(["Content cache", cacheSummary(metrics)]);
  rows.push(["Fleet cache", fleetCacheSummary(metrics)]);
  rows.push(["Elastic fleet", elasticSummary(metrics)]);
  rows.push(["Preemption", preemptionSummary(metrics)]);
  return rows;
}

// Disaggregated stage-split serving (cluster/stages): per-pool depth
// and occupancy, the mean decode batch (cross-request VAE coalescing),
// latent-transfer volume, and the loud redispatch counter for work a
// dead stage worker was holding (docs/stages.md).
export function stagesSummary(metrics) {
  const depthFam = metrics && metrics.cdt_stage_queue_depth;
  const occFam = metrics && metrics.cdt_stage_occupancy;
  const jobs = countsByLabel(metrics, "cdt_stage_jobs_total", "stage");
  const total = Object.values(jobs).reduce((a, b) => a + b, 0);
  if (!depthFam && !total) return "fused path";
  const parts = [];
  const occBy = {};
  for (const s of ((occFam && occFam.series) || [])) {
    occBy[(s.labels || {}).stage || "?"] = s.value;
  }
  const depthBy = {};
  for (const s of ((depthFam && depthFam.series) || [])) {
    depthBy[(s.labels || {}).stage || "?"] = s.value;
  }
  for (const stage of ["encode", "denoise", "decode"]) {
    if (stage in depthBy || stage in occBy) {
      const occ = stage in occBy
        ? ` ${(occBy[stage] * 100).toFixed(0)}%` : "";
      parts.push(`${stage} q${depthBy[stage] || 0}${occ}`);
    }
  }
  const dec = mergeHistogram(metrics, "cdt_decode_batch_size");
  if (dec && dec.count) {
    parts.push(`decode x̄ ${(dec.sum / dec.count).toFixed(2)}`);
  }
  const xfer = mergeHistogram(metrics, "cdt_latent_transfer_bytes");
  if (xfer && xfer.count) {
    parts.push(`${xfer.count} handoffs ${(xfer.sum / (1024 * 1024)).toFixed(1)} MB`);
  }
  const steals = seriesSum(metrics, "cdt_stage_steals_total");
  if (steals > 0) parts.push(`${steals} steals`);
  const redisp = countsByLabel(metrics, "cdt_stage_jobs_total", "outcome")
    .redispatch || 0;
  if (redisp > 0) parts.push(`${redisp} REDISPATCHED`);
  return parts.length ? parts.join(" · ") : "fused path";
}

// Step-granular preemption (cluster/preemption.py): preempt counts by
// reason, currently-parked jobs, checkpoint footprint, resume p95, and
// the loud dead-letter counter that means a checkpoint repeatedly
// failed restore (docs/preemption.md).
export function preemptionSummary(metrics) {
  const byReason = countsByLabel(metrics, "cdt_preemptions_total", "reason");
  const total = Object.values(byReason).reduce((a, b) => a + b, 0);
  const parked = seriesSum(metrics, "cdt_jobs_preempted");
  if (!total && !parked) return "none";
  const parts = [];
  if (total > 0) parts.push(fmtCounts(byReason));
  if (parked > 0) parts.push(`${parked} parked`);
  const bytes = seriesSum(metrics, "cdt_checkpoint_bytes");
  if (bytes > 0) parts.push(`${(bytes / (1024 * 1024)).toFixed(1)} MB ckpt`);
  const resume = mergeHistogram(metrics, "cdt_resume_seconds");
  if (resume && resume.count) {
    parts.push(`resume p95 ${fmtSeconds(histQuantile(resume, 0.95))}`);
  }
  const dead = seriesSum(metrics, "cdt_checkpoint_dead_letters_total");
  if (dead > 0) parts.push(`${dead} DEAD-LETTERED`);
  return parts.join(" · ");
}

// Content cache (cluster/cache): per-tier hit rates, coalesce width, and
// the two loud counters — corruption rejections and hash-tokenization
// fallbacks — that each mean an operator should look (docs/caching.md).
export function cacheSummary(metrics) {
  const hits = countsByLabel(metrics, "cdt_cache_hits_total", "tier");
  const misses = countsByLabel(metrics, "cdt_cache_misses_total", "tier");
  const tiers = [...new Set([...Object.keys(hits), ...Object.keys(misses)])]
    .filter((t) => t).sort();
  const parts = [];
  for (const t of tiers) {
    const h = hits[t] || 0;
    const total = h + (misses[t] || 0);
    if (total) parts.push(`${t} ${(100 * h / total).toFixed(0)}% of ${total}`);
  }
  const width = mergeHistogram(metrics, "cdt_coalesce_width");
  if (width && width.count && width.sum > width.count) {
    parts.push(`coalesce x̄ ${(width.sum / width.count).toFixed(2)}`);
  }
  const corrupt = seriesSum(metrics, "cdt_cache_corrupt_total");
  if (corrupt > 0) parts.push(`${corrupt} CORRUPT rejected`);
  const hashTok = seriesSum(metrics, "cdt_hash_tokenization_total");
  if (hashTok > 0) parts.push(`${hashTok} hash-tokenized`);
  return parts.length ? parts.join(" · ") : "no cacheable traffic";
}

// Fleet cache tier (cluster/cache/fleet.py): consistent-hash ring size,
// remote serve outcomes over GET /distributed/cache/entry/{key}, async
// fill/handback traffic, and the opt-in near tier's reuse counters
// (docs/caching.md "Fleet tier").
export function fleetCacheSummary(metrics) {
  const fam = "cdt_fleet_cache_remote_total";
  const ring = seriesSum(metrics, "cdt_fleet_ring_size");
  const remoteHits = seriesSum(metrics, fam, { op: "get", outcome: "hit" });
  const remoteOther =
    seriesSum(metrics, fam, { op: "get", outcome: "miss" }) +
    seriesSum(metrics, fam, { op: "get", outcome: "error" }) +
    seriesSum(metrics, fam, { op: "get", outcome: "skipped" });
  const fills = seriesSum(metrics, fam, { op: "put", outcome: "hit" });
  const handback = seriesSum(metrics, fam, { op: "handback", outcome: "hit" });
  const nearReuse = seriesSum(metrics, "cdt_fleet_near_reuse_total");
  if (!ring && !remoteHits && !remoteOther && !nearReuse) {
    return "per-host only";
  }
  const parts = [`ring ${ring}`];
  const probes = remoteHits + remoteOther;
  if (probes) {
    parts.push(`remote ${remoteHits}/${probes} ` +
      `(${(100 * remoteHits / probes).toFixed(0)}%)`);
  }
  if (fills) parts.push(`${fills} fills`);
  if (handback) parts.push(`${handback} handed back`);
  if (nearReuse) {
    const saved = seriesSum(metrics, "cdt_fleet_near_steps_saved_total");
    parts.push(`near ${nearReuse} reuse (${saved} steps saved)`);
  }
  return parts.join(" · ");
}

// Elastic fleet (cluster/elastic): lifecycle states from the
// cdt_worker_drain_state gauge (0=active, 1=draining, 2=decommissioned),
// autoscale verdicts, steal-scheduler grants, and drain handbacks — the
// numbers that say whether scale events are graceful. Draining workers
// are named: "which worker is leaving?" is the operator's first question.
export function elasticSummary(metrics) {
  const fam = metrics && metrics.cdt_worker_drain_state;
  const series = (fam && fam.series) || [];
  const by = { active: [], draining: [], decommissioned: [] };
  for (const s of series) {
    const name = s.value >= 2 ? "decommissioned"
      : s.value >= 1 ? "draining" : "active";
    by[name].push((s.labels || {}).worker || "?");
  }
  const parts = [];
  if (by.active.length) parts.push(`${by.active.length} active`);
  if (by.draining.length) parts.push(
    `${by.draining.length} draining (${by.draining.sort().join(", ")})`);
  if (by.decommissioned.length) parts.push(
    `${by.decommissioned.length} decommissioned`);
  const scaled = countsByLabel(
    metrics, "cdt_autoscale_decisions_total", "direction");
  const acted = (scaled.up || 0) + (scaled.down || 0);
  if (acted > 0) parts.push(
    `scale ${scaled.up || 0}↑ ${scaled.down || 0}↓`);
  const stolen = seriesSum(metrics, "cdt_steal_assignments_total",
                           { kind: "stolen" });
  if (stolen > 0) parts.push(`${stolen} stolen`);
  const handbacks = seriesSum(metrics, "cdt_drain_handbacks_total");
  if (handbacks > 0) parts.push(`${handbacks} handed back`);
  return parts.length ? parts.join(" · ") : "static fleet";
}

// Serving front door (cluster/frontdoor): admission outcomes, mean
// microbatch occupancy, and queue-wait p95 — the three numbers that say
// whether cross-user batching is earning its window.
export function frontDoorSummary(metrics) {
  const admissions = countsByLabel(metrics, "cdt_admission_total", "outcome");
  const total = Object.values(admissions).reduce((a, b) => a + b, 0);
  if (!total) return "no traffic";
  const parts = [fmtCounts(admissions)];
  const occ = mergeHistogram(metrics, "cdt_batch_size");
  if (occ && occ.count) {
    parts.push(`batch x̄ ${(occ.sum / occ.count).toFixed(2)}`);
  }
  const wait = mergeHistogram(metrics, "cdt_queue_wait_seconds");
  if (wait && wait.count) {
    parts.push(`wait p95 ${fmtSeconds(histQuantile(wait, 0.95))}`);
  }
  const fallbacks = seriesSum(metrics, "cdt_batch_fallbacks_total");
  if (fallbacks > 0) parts.push(`${fallbacks} fallback`);
  return parts.join(" · ");
}

// cdt_worker_breaker_state gauge (0=closed, 1=half-open, 2=open) →
// "3 closed · 1 open (w1)"; names the quarantined workers because that's
// the first question an operator asks.
export function breakerSummary(metrics) {
  const fam = metrics && metrics.cdt_worker_breaker_state;
  const series = (fam && fam.series) || [];
  if (!series.length) return "none tracked";
  const by = { closed: [], half_open: [], open: [] };
  for (const s of series) {
    const name = s.value >= 2 ? "open" : s.value >= 1 ? "half_open" : "closed";
    by[name].push((s.labels || {}).worker || "?");
  }
  const parts = [];
  if (by.closed.length) parts.push(`${by.closed.length} closed`);
  if (by.half_open.length) parts.push(`${by.half_open.length} half-open (${by.half_open.sort().join(", ")})`);
  if (by.open.length) parts.push(`${by.open.length} open (${by.open.sort().join(", ")})`);
  return parts.join(" · ");
}
