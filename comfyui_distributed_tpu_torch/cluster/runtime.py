"""The controller's prompt queue: validate, enqueue, execute one prompt
at a time in one execution thread (the solo path of the JAX package's
``cluster/runtime.py``, with its interrupt; groups, stages, preemption,
deadlines and the sweep are not ported).

The graph runs in the queue's one-thread pool, never on the event loop:
a node that talks to the control plane (the collector) hops back onto
the loop with ``run_in_loop`` while the loop goes on serving.
"""

from __future__ import annotations

import asyncio
import dataclasses
import secrets
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from ..graph.executor import GraphExecutor, strip_meta, validate_prompt
from ..graph.node import NODE_REGISTRY, is_link
from ..utils.logging import log, trace_info


@dataclasses.dataclass
class PromptJob:
    prompt_id: str
    prompt: dict
    client_id: str = ""
    trace_id: str | None = None
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)


class PromptQueue:
    """FIFO prompt queue with a single execution thread: one program on
    the card at a time."""

    def __init__(self, context_factory: Callable[[], dict] | None = None):
        self._pending: asyncio.Queue[PromptJob] = asyncio.Queue()
        self._context_factory = context_factory or (lambda: {})
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="graph-exec")
        self._task: Optional[asyncio.Task] = None
        self._executing: Optional[str] = None
        self._interrupt = threading.Event()
        self.history: dict[str, dict] = {}

    # --- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # a prompt already running finishes in its thread; nothing new starts
        self._interrupt.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    # --- producer ----------------------------------------------------------

    def enqueue(self, prompt: dict, client_id: str = "",
                trace_id: str | None = None) -> tuple[str, list]:
        """Validate and enqueue; returns (prompt_id, node_errors). An
        invalid prompt never reaches the queue."""
        prompt = strip_meta(prompt)
        errors = validate_prompt(prompt)
        if errors:
            return "", [e.as_dict() for e in errors]
        prompt_id = f"p_{int(time.time()*1000)}_{secrets.token_hex(3)}"
        self._pending.put_nowait(PromptJob(prompt_id, prompt, client_id,
                                           trace_id))
        self.start()
        return prompt_id, []

    def interrupt(self) -> int:
        """Drop the pending prompts into history as ``interrupted`` and
        flag the running one, which stops before its next node (a node
        already running finishes). Returns the number dropped."""
        dropped = 0
        while True:
            try:
                job = self._pending.get_nowait()
            except asyncio.QueueEmpty:
                break
            self.history[job.prompt_id] = {"status": "interrupted",
                                           "duration": 0.0}
            dropped += 1
        if self._executing:
            self._interrupt.set()
        return dropped

    @property
    def queue_remaining(self) -> int:
        return self._pending.qsize() + (1 if self._executing else 0)

    @property
    def executing(self) -> Optional[str]:
        return self._executing

    # --- consumer ----------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            job = await self._pending.get()
            self._executing = job.prompt_id
            self._interrupt.clear()
            try:
                await self._run_solo(loop, job, time.monotonic())
            finally:
                self._executing = None

    async def _run_solo(self, loop, job: PromptJob, started: float) -> str:
        try:
            context = dict(self._context_factory())
            context["interrupt_event"] = self._interrupt
            context["prompt_id"] = job.prompt_id
            outputs = await loop.run_in_executor(
                self._pool, GraphExecutor(context).execute, job.prompt)
            self.history[job.prompt_id] = {
                "status": "success",
                "duration": time.monotonic() - started,
                "outputs": {nid: out for nid, out in outputs.items()
                            if _is_terminal(job.prompt, nid)},
            }
            trace_info(job.trace_id,
                       f"prompt {job.prompt_id} done in "
                       f"{self.history[job.prompt_id]['duration']:.2f}s")
            return "success"
        except InterruptedError:
            self.history[job.prompt_id] = {
                "status": "interrupted",
                "duration": time.monotonic() - started,
            }
            log(f"prompt {job.prompt_id} interrupted")
            return "interrupted"
        except Exception as e:  # noqa: BLE001 — one prompt's failure is its own
            self.history[job.prompt_id] = {
                "status": "error", "error": str(e),
                "duration": time.monotonic() - started,
            }
            log(f"prompt {job.prompt_id} failed: {e!r}\n"
                f"{traceback.format_exc()}")
            return "error"


def _is_terminal(prompt: dict, nid: str) -> bool:
    """An output node, or a node nothing in the prompt consumes."""
    cls = NODE_REGISTRY.get(prompt.get(nid, {}).get("class_type", ""))
    if cls is None:
        return False
    consumed = {
        v[0] for node in prompt.values()
        for v in node.get("inputs", {}).values()
        if is_link(v)
    }
    return cls.OUTPUT_NODE or nid not in consumed
