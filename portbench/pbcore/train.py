"""The training driver: one run of a training cell.

Set-up builds what ``launch/train.py`` builds (the program's ``Model`` on
the benchmark's weights, ``make_train_step`` with the mix's optimizer
and schedule) and drives that one step object from the seed through its
first ``checked_steps`` steps, through the same call and feed as the
window: their losses, the first gradient (worked out from the
optimizer's first moment after step 1) and each leaf's change after the
last of them are the readings the output check holds against the plain
reference (``reftrain.py``).  The window then runs the same object's
steps back to back, each on a fresh batch drawn on the card from the
seed, reading each step's loss, until ``seconds`` have passed: it ends
with the step that ends past them, and its rate is over every step it
ran and all its time.  Then the program is freed and the reference runs
the checked steps again from the same weights and batches.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import torch

from .reftrain import ADAMW, RefTrainer, batch, norms, split_leaves, \
    train_numbers
from .serve import program_config
from .trace import DeviceTrace, Span, Spans
from .weights import make_weights

#: the profiler over the window: from this share of it on ...
PROFILE_FROM = 0.4
#: ... for at least this many seconds (whole steps)
PROFILE_S = 4.0


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as ``{"a.b.c": tensor}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class TrainRun:
    """One run of a training cell: ``setup``, ``window``, ``close``, then
    ``check`` for the output check."""

    def __init__(self, spec: Dict, mix: Dict, seed: int, seconds: float,
                 trace: bool, device: str = "cuda"):
        self.spec, self.mix, self.seed = spec, mix, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.rows, self.seq = int(mix["batch"]), int(mix["seq"])
        self.spans = Spans(
            "", "host between steps") if self.trace else None
        self.losses: List[float] = []
        self.window_steps = 0
        self.memory_peak = self.window_peak = 0
        self.profile = None
        self.readings: Optional[Dict] = None
        self._lines: List[str] = []

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models.model import Model
        from repro_torch.optim import make_schedule
        from repro_torch.runtime.steps import make_train_step
        mix = self.mix
        self.cfg = program_config(self.spec)
        model = Model(self.cfg, device=self.device, params=make_weights(
            self.spec, self.seed, self.device,
            vocab_rows=self.cfg.padded_vocab))
        schedule = make_schedule(mix["schedule"], peak_lr=mix["peak_lr"],
                                 warmup=int(mix["warmup"]),
                                 total=int(mix["total_steps"]))
        self.train_step, init_state = make_train_step(
            model, schedule=schedule, optimizer=mix["optimizer"])
        self.state = init_state(model.params)
        del model
        self.readings = self._checked_steps(int(mix["checked_steps"]))
        self._sync()
        gc.collect()
        gc.freeze()

    def _step(self, i: int) -> float:
        """Step ``i`` on its batch; its loss, read on the host."""
        b = batch(self.seed, i, self.rows, self.seq,
                  self.spec["vocab_size"], self.device)
        t0 = time.perf_counter()
        self.state, metrics = self.train_step(self.state, b)
        loss = float(metrics["loss"])
        if self.spans is not None and self.spans.recording:
            self.spans.spans.append(Span("train_step", t0,
                                         time.perf_counter(), {}))
        return loss

    def _checked_steps(self, n: int) -> Dict:
        V = self.spec["vocab_size"]
        out: Dict = {"loss": []}
        for i in range(n):
            out["loss"].append(self._step(i))
            if i == 0:
                # the optimizer's first moment after one step is
                # (1 - b1) x the gradient it got
                m = flat(self.state.opt.m)
                out["grad"] = {k: x / (1.0 - ADAMW["b1"]) for k, x in
                               norms(split_leaves(m, V)).items()}
        w0 = make_weights(self.spec, self.seed, self.device,
                          vocab_rows=self.cfg.padded_vocab)
        now = flat(self.state.params)
        w0 = dict(split_leaves(w0, V))
        out["change"] = norms((k, t.float() - w0[k].float())
                              for k, t in split_leaves(now, V))
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ----------------------------------------------------
    def window(self) -> None:
        cuda = self.device.type == "cuda"
        if cuda:
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.spans is not None:
            self.spans.recording = True
        trace = None
        i = int(self.mix["checked_steps"])
        self.t0 = now = time.perf_counter()
        while True:
            self.losses.append(self._step(i))
            i += 1
            now = time.perf_counter()
            if self.trace and cuda:
                if trace is None and now - self.t0 >= \
                        PROFILE_FROM * self.seconds:
                    trace = DeviceTrace()
                    trace.start()
                    t_trace = now
                elif trace is not None and not trace.t_stop and \
                        now - t_trace >= PROFILE_S:
                    trace.stop()
            if now - self.t0 >= self.seconds:
                break
        self.t_end = now
        if trace is not None and not trace.t_stop:
            trace.stop()
        self.device_trace = trace
        self.window_steps = len(self.losses)
        if self.spans is not None:
            self.spans.recording = False
        if cuda:
            self.window_peak = int(torch.cuda.max_memory_allocated(
                self.device))
            self.memory_peak = max(self.memory_peak, self.window_peak)

    # -- results -------------------------------------------------------
    def end_to_end(self) -> Dict[str, float]:
        tokens = self.window_steps * self.rows * self.seq
        return {"train_tok_s": tokens / (self.t_end - self.t0)}

    @property
    def attempted(self) -> int:
        """Steps run, the checked steps of set-up included."""
        return int(self.mix["checked_steps"]) + self.window_steps

    @property
    def failed(self) -> int:
        losses = list(self.readings["loss"]) + self.losses
        return sum(not math.isfinite(x) for x in losses)

    def close(self) -> None:
        """Stop and free the program."""
        if self.device_trace is not None:
            self.profile = self.device_trace.reduce(self.spans)
        self.device_trace = None
        self.state = self.train_step = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------
    def reference(self, quant: Optional[str] = None,
                  half_batch: bool = False) -> Dict:
        """The reference's readings of the checked steps."""
        ref = RefTrainer(self.spec, self.mix, self.seed, self.device,
                         vocab_rows=self.cfg.padded_vocab, quant=quant,
                         half_batch=half_batch)
        return ref.run(int(self.mix["checked_steps"]))

    def check(self) -> Dict[str, float]:
        """The numbers compared: the program's readings against the
        reference's."""
        ref = self.reference()
        self._lines = [
            f"step {i + 1}: loss {a!r}, reference {b!r}"
            for i, (a, b) in enumerate(zip(self.readings["loss"],
                                           ref["loss"]))]
        return train_numbers(self.readings, ref)

    def report(self) -> List[str]:
        return self._lines
