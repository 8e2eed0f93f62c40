"""The serving driver: one run of a serving cell.

Set-up builds what ``launch/serve.py --frontend async --paged`` builds
(the program's ``LLMEngine`` on the benchmark's weights, a
``GraphServer`` on the paged backend, an ``AsyncFrontend``), then
serves a few warm-up requests through it, over the mix's range of
prompt lengths: the decode tick (one captured graph at the cell's
slots) and prefill and extend chunks of each kind have run once.

The load is a closed loop: each client streams its requests one after
another and sends the next when its stream ends.  The clients start
together; their first requests all arrive at an empty server, a burst no
later moment of the run sees, and run in step, so the window opens only
once every client's first request has ended (the pre-roll, part of
set-up).  The window then runs
``seconds``: its tails are over the requests sent in it, its rate over
the tokens streamed in it.  Clients stop sending when it closes, and the
requests in flight run to their end.  Then the program is freed and a
sample of the finished requests is held against the plain reference.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic as traffic_mod
from .reference import Reference, served_gap
from .trace import DeviceTrace, Spans
from .weights import make_weights

#: published config key -> the program's ``ArchConfig`` field
PROGRAM_KEYS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "num_local_experts": "num_experts",
    "num_experts_per_tok": "num_experts_per_tok",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings", "dtype": "dtype",
    "capacity_factor": "capacity_factor",
}
#: seconds a request may take after the window before it counts as lost
DRAIN_S = 120.0
#: warm-up requests: the eager prefill compiles nothing, and every decode
#: tick runs the one graph captured at the cell's slots
WARMUP = 8


def program_config(spec: Dict):
    """The program's ``ArchConfig``: the architecture ``spec["arch"]``
    with the sizes of the configuration file."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    # dense_d_ff 0 is d_ff again (``ArchConfig.__post_init__``)
    return dataclasses.replace(cfg, dense_d_ff=0, **{
        port: spec[key] for key, port in PROGRAM_KEYS.items() if key in spec})


@dataclasses.dataclass
class Sent:
    client: int
    index: int
    prompt: np.ndarray
    new_tokens: int
    t_send: float = 0.0
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    reason: str = ""
    error: str = ""
    preroll: bool = False

    @property
    def ok(self) -> bool:
        return not self.error and self.reason == "length" and \
            len(self.tokens) == self.new_tokens


def pct(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class ServeRun:
    """One run of a serving cell: ``setup``, ``window``, ``close``, then
    ``gaps`` for the output check."""

    def __init__(self, spec: Dict, mix: Dict, seed: int, seconds: float,
                 trace: bool, device: str = "cuda"):
        self.spec, self.mix, self.seed = spec, mix, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.traffic = traffic_mod.ServeTraffic(mix, spec["vocab_size"],
                                                self.seed)
        self.spans = Spans() if self.trace else None
        self.device_trace: Optional[DeviceTrace] = None
        self.sent: List[Sent] = []
        self.stats0 = self.stats1 = None
        self.memory_peak = 0
        #: per sampled request, where its widest gap lies and how near the
        #: reference's routing came to a tie there (MoE only)
        self.looks: Dict[str, str] = {}
        self._lines: List[str] = []

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models.moe import padded_experts
        from repro_torch.serving import (AsyncFrontend, GraphServer,
                                         LLMEngine, Policy)
        mix = self.mix
        self.cfg = program_config(self.spec)
        self.weights = make_weights(
            self.spec, self.seed, self.device,
            vocab_rows=self.cfg.padded_vocab,
            expert_rows=padded_experts(self.cfg) if self.cfg.num_experts
            else 0)
        self.engine = LLMEngine(self.cfg, params=self.weights,
                                max_len=int(mix["max_len"]),
                                device=self.device)
        if self.spans is not None:
            self.spans.wrap(self.engine)
        self.server = GraphServer(
            self.engine, num_slots=int(mix["slots"]), backend="paged",
            block_size=int(mix["block_size"]), chunk_size=int(mix["chunk"]),
            prefix_sharing=bool(mix["prefix_sharing"]),
            max_new_tokens=int(mix["new_tokens"]["max"]))
        self.front = AsyncFrontend(self.server,
                                   policy=Policy(timeout_ms=DRAIN_S * 1e3))
        warm = self.traffic.warmup(min(WARMUP, int(mix["clients"])))
        asyncio.run(self._warmup(warm))
        self._sync()
        # what set-up made stays: the collector's later passes skip it
        gc.collect()
        gc.freeze()

    async def _warmup(self, reqs) -> None:
        async def one(r):
            async for _ in self.front.stream(
                    r.prompt, request_id=f"warm{-r.index}",
                    max_new_tokens=r.new_tokens):
                pass
        await asyncio.gather(*(one(r) for r in reqs))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ----------------------------------------------------
    def window(self) -> None:
        """The pre-roll, the window and the drain; returns once every
        request sent has ended.  ``t0`` is when the window opened."""
        if self.spans is not None:
            self.spans.recording = True
        asyncio.run(self._serve())
        if self.spans is not None:
            self.spans.recording = False
        self.stats1 = self.server.stats()
        self._sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    async def _serve(self) -> None:
        clients = int(self.mix["clients"])
        self.t0 = self.t_end = math.inf
        self._waiting = clients
        self._opened = asyncio.Event()
        tasks = [asyncio.ensure_future(self._client(c, clients))
                 for c in range(clients)]
        await self._opened.wait()
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + self.seconds
        self.stats0 = self.server.stats()
        if self.trace and self.device.type == "cuda":
            tasks.append(asyncio.ensure_future(self._profile()))
        await asyncio.gather(*tasks)

    def _first_done(self) -> None:
        """A client's first request ended: the window opens with the last
        of them."""
        self._waiting -= 1
        if self._waiting == 0:
            self._opened.set()

    async def _profile(self) -> None:
        """The profiler over the middle of the window: from 0.4 of it, for
        a quarter of it, at most 4 s."""
        await asyncio.sleep(0.4 * self.seconds)
        self.device_trace = DeviceTrace()
        self.device_trace.start()
        await asyncio.sleep(min(4.0, 0.25 * self.seconds))
        self.device_trace.stop()

    async def _client(self, c: int, clients: int) -> None:
        first = True
        for req in self.traffic.client_requests(c, clients):
            if time.perf_counter() >= self.t_end:
                return
            rec = Sent(c, req.index, req.prompt, req.new_tokens,
                       preroll=self.t0 == math.inf)
            self.sent.append(rec)
            handles = []
            rec.t_send = time.perf_counter()
            try:
                async for tok in self.front.stream(
                        req.prompt, request_id=f"c{c}.{req.index}",
                        max_new_tokens=req.new_tokens,
                        on_handle=handles.append):
                    rec.stamps.append(time.perf_counter())
                    rec.tokens.append(int(tok))
                rec.reason = handles[-1].finish_reason
            except Exception as e:          # noqa: BLE001 - counted failed
                rec.error = f"{type(e).__name__}: {e}"
            if first:
                first = False
                self._first_done()

    # -- results -------------------------------------------------------
    def end_to_end(self) -> Dict[str, float]:
        """Tails over the requests sent in the window (a failed one misses
        every limit), the rate over the tokens streamed in it."""
        sent = [r for r in self.sent if not r.preroll]
        ttft = [(r.stamps[0] - r.t_send) * 1e3 if r.ok else math.inf
                for r in sent]
        tpot = [(r.stamps[-1] - r.stamps[0]) * 1e3 / (len(r.stamps) - 1)
                for r in sent if r.ok and len(r.stamps) > 1]
        out_tokens = sum(1 for r in self.sent for t in r.stamps
                         if self.t0 <= t < self.t_end)
        return {"ttft_p95_ms": pct(ttft, 95) if ttft else math.inf,
                "tpot_p95_ms": pct(tpot, 95) if tpot else math.inf,
                "output_tok_s": out_tokens / self.seconds}

    @property
    def attempted(self) -> int:
        """Requests sent, the pre-roll's included."""
        return len(self.sent)

    @property
    def failed(self) -> int:
        return sum(not r.ok for r in self.sent)

    def close(self) -> None:
        """Stop and free the program; the benchmark's weights stay."""
        self.server.close()
        if self.device_trace is not None:
            self.profile = self.device_trace.reduce(self.spans)
            self.device_trace = None
        else:
            self.profile = None
        self.server = self.front = self.engine = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------
    def sample(self) -> List[Sent]:
        """The finished requests the reference reads: the one that served
        the most tokens and ``mix["sample"] - 1`` more, drawn from the
        seed."""
        done = [r for r in self.sent if r.ok]
        if not done:
            return []
        longest = max(done, key=lambda r: (len(r.tokens), -r.index))
        rest = [r for r in done if r is not longest]
        rng = np.random.default_rng([self.seed, 5])
        k = min(len(rest), int(self.mix["sample"]) - 1)
        picks = rng.choice(len(rest), size=k, replace=False) if k else []
        return [longest] + [rest[i] for i in sorted(picks)]

    def gaps(self, quant: Optional[str] = None,
             reqs: Optional[List[Sent]] = None) -> Dict[str, np.ndarray]:
        """For each sampled request, the gap at each served position by
        which the served token's reference logit lies below the
        reference's best; with ``quant``, the gap of the token that the
        reference in that precision puts first instead (the control)."""
        ref = Reference(self.spec, self.weights)
        ctl = Reference(self.spec, self.weights, quant) if quant else None
        out = {}
        for r in (reqs if reqs is not None else self.sample()):
            seq = torch.as_tensor(np.concatenate(
                [r.prompt, np.asarray(r.tokens[:-1], np.int32)]),
                device=self.device)
            first = len(r.prompt) - 1
            logits = ref.logits(seq, first)
            if ctl is None:
                picked = torch.as_tensor(r.tokens, device=self.device)
            else:
                picked = ctl.logits(seq, first).argmax(-1)
            name = f"c{r.client}.{r.index}"
            out[name] = served_gap(logits, picked)
            if ref.router_margin is not None:
                margin = ref.router_margin[first:].double().cpu().numpy()
                at = int(out[name].argmax())
                self.looks[name] = (
                    f"; widest at served position {at}, router margin there"
                    f" {margin[at]!r}, median {float(np.median(margin))!r}")
            del logits
        return out


    def check(self) -> Dict[str, float]:
        """The numbers compared, of the sampled requests' gaps."""
        gaps = self.gaps()
        self._lines = [
            f"request {name}: {g.size} served tokens, logit gap widest "
            f"{g.max()!r} mean {g.mean()!r}{self.looks.get(name, '')}"
            for name, g in gaps.items()]
        return compared(gaps)

    def report(self) -> List[str]:
        return self._lines


def compared(gaps: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers a serving cell's check may compare: the widest gap
    over every sampled served token, and the mean gap over them."""
    every = np.concatenate(list(gaps.values())) if gaps else np.zeros(0)
    if not every.size:
        return {"logit_gap": math.inf, "logit_gap_mean": math.inf}
    return {"logit_gap": float(every.max()),
            "logit_gap_mean": float(every.mean())}
