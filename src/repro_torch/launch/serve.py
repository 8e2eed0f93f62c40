"""Serving launcher of the port: the continuous-batching GraphServer
(default), the asyncio streaming front door (``--frontend async``; see
docs/FRONTEND.md), or the original fixed-batch flow-limited graph
(``--fixed-batch``) around the port's LLMEngine, on the card
(``--device cuda``, the default) or the CPU (``--device cpu``).

    python -m repro_torch.launch.serve --arch qwen3_32b --reduced \
        --requests 32 --clients 8 --device cpu

    python -m repro_torch.launch.serve --arch granite_moe_3b_a800m \
        --no-reduced --paged --requests 16 --clients 4

A copy of the JAX package's ``launch/serve.py`` with two changes, both
in ``main``: ``--reduced`` can be turned off (``--no-reduced`` serves
the configuration at full width), and ``--device`` picks the engine's
device.
"""
from __future__ import annotations

import argparse
import asyncio
import sys
import threading
import time

import numpy as np

from ..configs import get_config
from ..core import Graph
from ..serving import (AsyncFrontend, GraphServer, LLMEngine, Policy,
                       build_serving_graph)
from .. import calculators  # noqa: F401 - registers basics


def _make_prompts(rng, n, vocab):
    # a few length buckets: grouped prefill engages, jit compiles stay few
    return [rng.randint(0, vocab, size=int(rng.choice([6, 10, 14, 18])))
            .astype(np.int32) for _ in range(n)]


def run_continuous(args, cfg, engine) -> int:
    """Multi-client demo: ``--clients`` threads submit concurrently; the
    server keeps the decode batch full across all of them."""
    rng = np.random.RandomState(args.seed)
    prompts = _make_prompts(rng, args.requests, cfg.vocab_size)
    lat = [None] * args.requests
    results = [None] * args.requests

    with GraphServer(engine, num_slots=args.num_slots,
                     max_in_flight=args.max_in_flight,
                     max_new_tokens=args.max_new_tokens,
                     chunk_size=args.chunk_size or None,
                     speculate_k=args.speculate,
                     paged=args.paged, num_blocks=args.num_blocks,
                     block_size=args.block_size,
                     admission=args.admission,
                     backend=args.backend,
                     spec_window=args.spec_window,
                     observe_dir=args.observe_dir or None) as srv:
        t0 = time.time()

        def client(worker: int) -> None:
            for i in range(worker, args.requests, args.clients):
                # cycle per-request priorities 0..--priority (0 = FIFO)
                prio = i % (args.priority + 1) if args.priority else 0
                h = srv.submit(prompts[i], request_id=f"req{i}",
                               priority=prio)
                results[i] = h.result(timeout=600)
                lat[i] = time.time() - t0

        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        stats = srv.stats()
        if args.observe_dir:
            arts = srv.dump_observability()
            print(f"observability: wrote {len(arts)} artifacts to "
                  f"{args.observe_dir}")

    done = sum(r is not None for r in results)
    toks = sum(len(r) for r in results if r is not None)
    ls = sorted(l for l in lat if l is not None)
    print(f"served {done}/{args.requests} requests from {args.clients} "
          f"clients in {wall:.2f}s ({toks / wall:.1f} tok/s)")
    if ls:
        print(f"latency p50={ls[len(ls)//2]*1e3:.0f}ms "
              f"p95={ls[int(len(ls)*0.95)]*1e3:.0f}ms")
    sched = stats.get("scheduler", {})
    print(f"admitted={stats.get('admitted')} dropped={stats.get('dropped')} "
          f"decode_steps={sched.get('decode_steps')} "
          f"prefill_calls={sched.get('prefill_calls')} "
          f"max_active_slots={sched.get('max_active_slots')}")
    print(f"scheduler: preemptions={sched.get('preemptions')} "
          f"replayed_tokens={sched.get('replayed_tokens')} "
          f"chunked_prefill_ticks={sched.get('chunked_prefill_ticks')} "
          f"extend_prefills={sched.get('extend_prefills')}")
    if sched.get("spec_steps"):
        rate = sched["spec_accepted"] / max(1, sched["spec_drafted"])
        print(f"speculative: spec_steps={sched['spec_steps']} "
              f"drafted={sched['spec_drafted']} "
              f"accepted={sched['spec_accepted']} "
              f"(accept rate {rate:.0%}, "
              f"{sched['spec_emitted'] / sched['spec_steps']:.2f} "
              f"tokens/verify-tick)")
    if "block_pool" in stats:
        bp = stats["block_pool"]
        print(f"block pool: {bp['num_blocks']}x{bp['block_size']} tokens, "
              f"peak_in_use={bp['peak_in_use']} "
              f"prefill_tokens_saved="
              f"{sched.get('prefill_tokens_saved', 0)}")
    if sched.get("state_slabs_peak") is not None:
        print(f"state slabs: peak_in_use={sched['state_slabs_peak']} "
              f"in_use={sched['state_slabs_in_use']}")
    return 0 if done == args.requests else 1


def run_async(args, cfg, engine) -> int:
    """Async streaming demo: every request is one ``async for`` over
    :meth:`AsyncFrontend.stream`; a ``--cancel-frac`` slice of clients
    disconnects after two tokens (server-side cancellation frees their
    cache memory); ``--deadline-ms`` / ``--ttft-ms`` attach SLO budgets
    (docs/FRONTEND.md)."""
    rng = np.random.RandomState(args.seed)
    prompts = _make_prompts(rng, args.requests, cfg.vocab_size)
    cancel = [rng.rand() < args.cancel_frac for _ in range(args.requests)]
    slo = {}
    if args.deadline_ms:
        slo["deadline_ms"] = args.deadline_ms
    if args.ttft_ms:
        slo["ttft_ms"] = args.ttft_ms
    ttft = [None] * args.requests
    ntok = [0] * args.requests
    reasons = [None] * args.requests

    with GraphServer(engine, num_slots=args.num_slots,
                     max_in_flight=args.max_in_flight,
                     max_new_tokens=args.max_new_tokens,
                     chunk_size=args.chunk_size or None,
                     speculate_k=args.speculate,
                     paged=args.paged, num_blocks=args.num_blocks,
                     block_size=args.block_size,
                     admission=args.admission,
                     backend=args.backend,
                     spec_window=args.spec_window,
                     observe_dir=args.observe_dir or None) as srv:
        front = AsyncFrontend(srv, policy=Policy(
            timeout_ms=args.timeout_ms, retries=args.retries))
        t0 = time.time()

        async def client(i):
            hbox = []
            agen = front.stream(prompts[i], request_id=f"req{i}",
                                on_handle=hbox.append, **slo)
            try:
                async for _tok in agen:
                    if ttft[i] is None:
                        ttft[i] = time.time() - t0
                    ntok[i] += 1
                    if cancel[i] and ntok[i] >= 2:
                        reasons[i] = "disconnect"
                        break
            finally:
                await agen.aclose()
            if reasons[i] is None:
                reasons[i] = hbox[-1].finish_reason or "length"

        async def run_all():
            await asyncio.gather(*(client(i)
                                   for i in range(args.requests)))

        asyncio.run(run_all())
        wall = time.time() - t0
        stats = srv.stats()
        if args.observe_dir:
            arts = srv.dump_observability()
            print(f"observability: wrote {len(arts)} artifacts to "
                  f"{args.observe_dir}")

    toks = sum(ntok)
    ts = sorted(t for t in ttft if t is not None)
    print(f"async: streamed {toks} tokens from {args.requests} requests "
          f"in {wall:.2f}s ({toks / wall:.1f} tok/s)")
    if ts:
        print(f"ttft p50={ts[len(ts)//2]*1e3:.0f}ms "
              f"p95={ts[int(len(ts)*0.95)]*1e3:.0f}ms")
    by_reason = {}
    for r in reasons:
        by_reason[r] = by_reason.get(r, 0) + 1
    sched = stats.get("scheduler", {})
    print(f"finish reasons: {by_reason}  "
          f"cancelled={sched.get('requests_cancelled')} "
          f"deadline_missed={sched.get('deadline_missed')} "
          f"preemptions={sched.get('preemptions')}")
    return 0


def run_fixed_batch(args, cfg, engine) -> int:
    """The original batch-and-drain pipeline (kept for comparison)."""
    graph_cfg = build_serving_graph(batch_size=args.batch_size,
                                    max_in_flight=args.max_in_flight or 2)
    g = Graph(graph_cfg, side_packets={"engine": engine})

    done = {}
    latencies = {}
    t_submit = {}

    def on_response(p):
        done[p.payload["id"]] = p.payload["tokens"]
        latencies[p.payload["id"]] = time.time() - t_submit[p.payload["id"]]

    g.observe_output_stream("responses", on_response)
    g.start_run()
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        rid = f"req{i}"
        t_submit[rid] = time.time()
        g.add_packet_to_input_stream("requests", {
            "tokens": rng.randint(0, cfg.vocab_size,
                                  size=rng.randint(4, 24)).tolist(),
            "id": rid, "max_new_tokens": args.max_new_tokens,
        }, i)
    g.close_all_input_streams()
    g.wait_until_done(timeout=600)
    wall = time.time() - t0
    lat = sorted(latencies.values())
    print(f"served {len(done)}/{args.requests} requests in {wall:.2f}s "
          f"({len(done) * args.max_new_tokens / wall:.1f} tok/s)")
    print(f"latency p50={lat[len(lat)//2]*1e3:.0f}ms "
          f"p95={lat[int(len(lat)*0.95)]*1e3:.0f}ms")
    hist = g.tracer.node_histograms(g.node_names())
    for k, v in sorted(hist.items()):
        print(f"  {k:10s} runs={v['count']:4.0f} mean={v['mean_us']:9.0f}us "
              f"max={v['max_us']:9.0f}us")
    return 0 if len(done) == args.requests else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm_2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the configuration's reduced smoke size; "
                         "--no-reduced serves it at full width")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-in-flight", type=int, default=0)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="use the original batch-and-drain pipeline")
    ap.add_argument("--backend",
                    choices=["slot", "paged", "state", "hybrid"],
                    default=None,
                    help="cache backend: contiguous slot rows, the paged "
                         "block pool, O(1) recurrent state slabs, or the "
                         "Jamba-style per-layer hybrid (attention pages + "
                         "state slabs; see docs/STATE_CACHE.md)")
    ap.add_argument("--paged", action="store_true",
                    help="shorthand for --backend paged (ref-counted "
                         "prefix sharing; see docs/KV_CACHE.md)")
    ap.add_argument("--spec-window", type=int, default=8,
                    help="state/hybrid backends: cap on the speculative "
                         "verify window (bounds per-position state "
                         "snapshot memory; see docs/STATE_CACHE.md)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="chunked prefill: ingest prompts this many "
                         "tokens per scheduler tick (0 = whole prompt)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="self-speculative decoding: draft up to K "
                         "tokens per tick by prompt lookup and verify "
                         "them in one pass (0 = plain greedy; see "
                         "docs/SPECULATIVE.md)")
    ap.add_argument("--priority", type=int, default=0,
                    help="cycle request priorities 0..N (higher admitted "
                         "first, preempted last); 0 = plain FIFO")
    ap.add_argument("--admission", choices=["preempt", "reserve"],
                    default="preempt",
                    help="paged admission: optimistic + preemption "
                         "(default) or PR 3's worst-case reservation")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged arena size in blocks (0 = num_slots "
                         "worst-case rows)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--frontend", choices=["threads", "async"],
                    default="threads",
                    help="client driver: blocking handles from worker "
                         "threads, or the asyncio streaming front door "
                         "(docs/FRONTEND.md)")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="whole-request SLO budget; expired requests "
                         "finish with reason 'deadline' (0 = off)")
    ap.add_argument("--ttft-ms", type=float, default=0,
                    help="first-token SLO budget; also lets the request "
                         "preempt a lower-priority decoder (0 = off)")
    ap.add_argument("--cancel-frac", type=float, default=0.0,
                    help="async frontend: fraction of clients that "
                         "disconnect after two tokens")
    ap.add_argument("--timeout-ms", type=float, default=120_000.0,
                    help="frontend policy timeout per request")
    ap.add_argument("--retries", type=int, default=0,
                    help="frontend policy: resubmissions for requests "
                         "that failed before their first token")
    ap.add_argument("--observe-dir", default="",
                    help="write trace.json / requests.perfetto.json / "
                         "timelines.json / metrics.{json,prom} / "
                         "provenance.json here after the run, and arm "
                         "the flight recorder for incident dumps "
                         "(docs/OBSERVABILITY.md)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (the hand-written "
                         "kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine = LLMEngine(cfg, max_len=128, seed=args.seed, device=args.device)
    if args.fixed_batch:
        return run_fixed_batch(args, cfg, engine)
    if args.frontend == "async":
        return run_async(args, cfg, engine)
    return run_continuous(args, cfg, engine)


if __name__ == "__main__":
    sys.exit(main())
