"""Device time of one kernel or layer of the program, alone, at a cell's
shapes: CUDA events around calls queued back to back behind a sleep
kernel, so that the host's launch time is not in the reading (the
arithmetic of ``chip_smoke.py``'s ``queued_ms``, copied)."""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Tuple

import torch

from . import costs

#: the card's clock: cycles of ``torch.cuda._sleep`` per millisecond
SLEEP_CYCLES_PER_MS = 1_980_000
REPS = 20


def queued_ms(fn: Callable[[], object], reps: int = REPS) -> float:
    """Device ms per call of ``fn``.  Calls go in batches queued behind a
    sleep of 4x their host time, halved until each batch queues (the
    card's launch queue is finite); raises where one call alone does
    not queue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(walls)
    n = reps
    while True:
        total, queued = 0.0, True
        for i in range(0, reps, n):
            k = min(n, reps - i)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(int((4 * k * host_ms + 1.0)
                                  * SLEEP_CYCLES_PER_MS))
            start.record()
            for _ in range(k):
                fn()
            end.record()
            queued = queued and not start.query()
            end.synchronize()
            total += start.elapsed_time(end)
            if not queued and n > 1:
                break
        if queued:
            return total / reps
        if n == 1:
            raise RuntimeError("one call does not queue: its events "
                               "would hold the host's gaps")
        n = (n + 1) // 2


def _randn(shape, gen, device, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def k2_decode(spec: Dict, rows: int, keys: int, block_size: int,
              max_len: int, device) -> Tuple[float, float, float]:
    """K2 (``ops.fused_flash_decode``, paged) over ``rows`` rows of
    ``keys`` keys each: (ms, flops, bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rope_freqs
    H, KV, hd = (spec["num_attention_heads"], spec["num_key_value_heads"],
                 spec["head_dim"])
    gen = torch.Generator(device=device).manual_seed(0)
    pages = -(-keys // block_size)
    P = max_len // block_size
    NB = 1 + rows * pages
    k_pages = _randn((NB, block_size, KV, hd), gen, device)
    v_pages = _randn((NB, block_size, KV, hd), gen, device)
    tables = torch.zeros((rows, P), dtype=torch.int32, device=device)
    tables[:, :pages] = 1 + torch.arange(rows * pages, dtype=torch.int32,
                                         device=device).view(rows, pages)
    positions = torch.full((rows,), keys - 1, dtype=torch.int32,
                           device=device)
    q = _randn((rows, 1, H, hd), gen, device)
    k_new = _randn((rows, 1, KV, hd), gen, device)
    v_new = _randn((rows, 1, KV, hd), gen, device)
    freqs = rope_freqs(hd, spec["rope_theta"], device)
    with torch.no_grad():
        ms = queued_ms(lambda: ops.fused_flash_decode(
            q, k_new, v_new, k_pages, v_pages, tables, positions, freqs))
    flops, nbytes = costs.flash_decode_cost([keys - 1] * rows, H, KV, hd, P)
    return ms, flops, nbytes


def k3_prefill(spec: Dict, chunk: int, prefix: int,
               device) -> Tuple[float, float, float]:
    """K3 (``ops.flash_attention``) over one chunk of ``chunk`` query rows
    behind ``prefix`` cached keys: (ms, flops, bytes)."""
    from repro_torch.kernels import ops
    H, KV, hd = (spec["num_attention_heads"], spec["num_key_value_heads"],
                 spec["head_dim"])
    gen = torch.Generator(device=device).manual_seed(0)
    T = prefix + chunk
    q = _randn((1, chunk, H, hd), gen, device)
    k = _randn((1, T, KV, hd), gen, device)
    v = _randn((1, T, KV, hd), gen, device)
    with torch.no_grad():
        ms = queued_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   q_offset=prefix))
    flops, nbytes = costs.flash_attention_cost(1, chunk, T, H, KV, hd,
                                               q_offset=prefix)
    return ms, flops, nbytes


def moe_layer(spec: Dict, program_cfg, weights: Dict[str, torch.Tensor],
              rows: int, device) -> Tuple[float, float, float]:
    """The program's MoE FFN (``models.moe.moe_apply``) of layer 0 over
    ``rows`` tokens: (ms, flops, bytes), the bytes counting the experts
    these tokens reach."""
    from repro_torch.models import moe
    d, E = spec["hidden_size"], spec["num_local_experts"]
    layer = {n: weights["blocks.l0.ffn." + n][0]
             for n in ("router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device=device).manual_seed(0)
    x = _randn((1, rows, d), gen, device)
    with torch.no_grad():
        probs = torch.softmax(x[0].float() @ layer["router"][:, :E].float(),
                              -1)
        hit = int(torch.topk(probs, spec["num_experts_per_tok"], -1)
                  .indices.unique().numel())
        ms = queued_ms(lambda: moe.moe_apply(layer, program_cfg, x))
    flops, nbytes = costs.moe_ffn_cost(rows, d, spec["intermediate_size"],
                                       spec["num_experts_per_tok"], E, hit)
    return ms, flops, nbytes
