// Sampling-progress poll state machine, DOM-free (extracted from
// main.js's trackProgress so node:test can cover it — VERDICT r3 next
// #8). Consumes /distributed/progress snapshots; decides label, bar
// width, preview refetch, and when to stop polling.

// A prompt can sit behind a long serial queue and a cold compile alone
// can take minutes — keep polling ~10 min of misses before giving up.
export const MAX_MISSES = 800;

export function newPollState() {
  return { misses: 0, lastStep: -1 };
}

export function progressLabel(snap) {
  if (snap.failed) return `failed at step ${snap.step}/${snap.total}`;
  if (snap.done) return `done (${snap.total} steps)`;
  return `step ${snap.step}/${snap.total}`;
}

// One poll tick. `snap` is the progress snapshot or null (404/transport).
// Returns {label, widthPct, refetchPreview, stop, hide} and updates
// `state` in place.
export function pollTick(state, snap) {
  if (!snap) {
    state.misses += 1;
    if (state.misses > MAX_MISSES) {
      return { label: "", widthPct: null, refetchPreview: false,
               stop: true, hide: true };
    }
    return { label: "queued…", widthPct: null, refetchPreview: false,
             stop: false, hide: false };
  }
  state.misses = 0;
  // refetch the preview image only when a NEW step reported — refetching
  // every 750 ms would hammer the PNG encoder for identical bytes
  const refetch = snap.step > 0 && snap.step !== state.lastStep;
  if (refetch) state.lastStep = snap.step;
  return {
    label: progressLabel(snap),
    widthPct: Math.round(snap.fraction * 100),
    refetchPreview: refetch,
    stop: !!snap.done,
    hide: false,
  };
}
