"""Step factories: the train step (loss, gradients by autograd on the
plain path, the optimizer update), and for serving prompt ingestion,
lockstep decode,
continuous-batching decode and speculative verify over slot rows, a
paged arena, state slabs or the hybrid of the last two, the row inserts
of every layout, chunked / prefix-extend prefill, and the state
layouts' stack-returning verify and rewind.

The steps run eagerly.  Decode and verify take every input (and the
state verify its stack buffers) as a tensor of a fixed shape and make
no host round trip, so the engine can capture them as CUDA graphs
(``runtime/graphs.py``); prefill, extend, the inserts and the rewind
change shape with every prompt or chunk, or are a copy, and stay
eager.  Caches are updated in place (see ``models.transformer``); each
step still returns the cache so callers read like the JAX package's.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..models import paging
from ..models import transformer as tf
from ..models.model import Model
from ..models.params import flatten, unflatten
from ..models.transformer import DEFAULT_FLAGS, TRAIN_FLAGS, RuntimeFlags
from ..optim import make_optimizer
from ..optim.optimizers import BLOCK, OptState
from ..sharding.group import own_range, placed, tp_reduce_parts


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE in f32.  logits [B,S,V], labels [B,S]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """``sum(square(g.astype(f32)))`` a block at a time."""
    flat = g.reshape(-1)
    return sum(torch.sum(torch.square(b.float()))
               for b in flat.split(BLOCK))


def make_train_step(model: Model, *, schedule: Callable,
                    flags: RuntimeFlags = TRAIN_FLAGS,
                    optimizer: Optional[str] = None, mesh=None, pool=None):
    """The JAX ``make_train_step``: ``(train_step, init_state)``.

    ``train_step(state, batch) -> (state, metrics)``: the loss of
    ``batch`` (``tokens``, ``labels``, and a modality stub's
    ``prefix_embeds`` or ``enc_embeds``: tensors on the model's device)
    — the CE, masked past a prefix, plus ``router_aux_weight`` x the
    MoE load-balance loss, plus 0.3 x the MTP loss where the
    architecture has an MTP head — its gradients by autograd, the
    learning rate ``schedule(step + 1)``, and the optimizer update,
    which writes the params and the optimizer state **in place** and
    returns them.  ``metrics``: ``loss`` (the CE), ``aux``, ``mtp_loss``
    where there is one, ``total_loss``, ``lr`` and ``grad_norm`` (each
    gradient leaf's squares summed in f32, as JAX sums them), as
    tensors.  The weights are made to require grad at each step.
    ``train_step.loss_fn(params, batch) -> (loss, metrics)`` is the loss
    alone.

    ``flags`` defaults to the plain path (``TRAIN_FLAGS``): the kernels
    have no backward, so kernel flags raise at the first kernel op
    (``ops.no_backward``); nothing falls back.

    ``mesh`` (``launch/mesh.py``'s ``make_host_mesh`` or
    ``make_production_mesh``) trains on its ranks (``runtime/
    train_mesh.py``): rank 0 is this process and starts the others (or
    takes ``pool``'s, a ``sharding.group.WorkerPool``).  Then
    ``init_state(params)`` cuts a whole tree into every rank's slices,
    ``init_state(seed=s)`` has each rank draw them as ``Model(cfg,
    seed=s)`` does, and both return rank 0's; ``train_step(state,
    batch)`` takes the whole batch and returns rank 0's state and the
    global metrics; ``train_step.trainer`` (a ``MeshTrainer``) reads
    every rank (``report``), gathers the whole state (``gather_state``)
    and stops the ranks (``close``).  A mesh of one rank is the
    unsharded step.  The flags take JAX's training flags (``moe_impl=
    "ep"``, ``batch_axes``, ``batch_divisor``, ``model_size``).  On a
    mesh of more than one rank ``model`` may be its config alone: the
    ranks draw or are given their slices, and no whole model is built."""
    cfg = getattr(model, "cfg", model)
    if mesh is not None:
        from .train_mesh import MeshTrainer, check_mesh_flags
        check_mesh_flags(cfg, flags, mesh, optimizer or cfg.optimizer)
        if len(mesh.devices) > 1:
            trainer = MeshTrainer(cfg, schedule, flags,
                                  optimizer or cfg.optimizer, mesh, pool)

            def mesh_step(state, batch):
                return trainer.train_step(state, batch)

            mesh_step.trainer = trainer
            return mesh_step, trainer.init_state
    opt_init, opt_update = make_optimizer(optimizer or cfg.optimizer)

    def loss_fn(params, batch):
        kw = {k: batch[k] for k in ("prefix_embeds", "enc_embeds")
              if k in batch}
        logits, aux, hidden = model.forward(batch["tokens"], flags=flags,
                                            params=params, **kw)
        labels = batch["labels"]
        mask = None
        if "prefix_embeds" in batch:
            P = batch["prefix_embeds"].shape[1]
            pos = torch.arange(labels.shape[1], device=labels.device)
            mask = (pos >= P).expand(labels.shape)
        ce = cross_entropy(logits, labels, mask)
        loss = ce + cfg.router_aux_weight * aux
        metrics = {"loss": ce, "aux": aux}
        if cfg.mtp_depth:
            # MTP: predict token t+2 from hidden_t (+ embed of t+1)
            mtp = tf.mtp_logits(params, cfg, hidden, batch["tokens"], flags)
            mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
            mtp_loss = cross_entropy(mtp, mtp_labels, mask)
            loss = loss + 0.3 * mtp_loss
            metrics["mtp_loss"] = mtp_loss
        return loss, metrics

    def train_step(state: TrainState, batch):
        leaves = flatten(state.params)
        for p in leaves.values():
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, batch)
            loss.backward()
        grads = {path: p.grad if p.grad is not None else torch.zeros_like(p)
                 for path, p in leaves.items()}
        for p in leaves.values():
            p.grad = None
        with torch.no_grad():
            gnorm = torch.sqrt(sum(_square_sum(g) for g in grads.values()))
            lr = schedule(state.opt.step + 1)
            new_params, new_opt = opt_update(unflatten(grads), state.opt,
                                             state.params, lr)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(total_loss=loss.detach(), lr=lr, grad_norm=gnorm)
        return TrainState(new_params, new_opt), metrics

    def init_state(params) -> TrainState:
        return TrainState(params, opt_init(params))

    # the loss alone, ``(params, batch) -> (loss, metrics)``, for callers
    # that read the gradients themselves
    train_step.loss_fn = loss_fn
    return train_step, init_state


def make_prefill_step(model: Model, max_cache_len: int,
                      flags: RuntimeFlags = DEFAULT_FLAGS):
    """Prompt ingestion: ``(tokens [B, S], prefix_embeds=None,
    enc_embeds=None) -> (first tokens [B], cache)``; the embeddings are
    the JAX step's optional batch keys of a modality stub."""
    def prefill_step(tokens: torch.Tensor,
                     prefix_embeds: Optional[torch.Tensor] = None,
                     enc_embeds: Optional[torch.Tensor] = None):
        logits, cache = model.prefill(tokens, max_cache_len, flags=flags,
                                      prefix_embeds=prefix_embeds,
                                      enc_embeds=enc_embeds)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS):
    """Lockstep decode: ``positions`` is a [B] int32 vector holding every
    row's common offset (a tensor, so that a captured step reads it from
    its input buffer)."""
    def decode_step(tokens, cache, positions):
        logits, cache = model.decode_step(tokens, cache, positions,
                                          flags=flags)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return decode_step


def kernel_path(cfg, flags: RuntimeFlags) -> str:
    """Which decode-attention implementation a serving step runs:
    ``"fused"`` (the fused flash-decode op, K2 or K4) or ``"fallback"``
    (K5 or the page gather on the paged layout, the plain fused version
    on the slot layout, MLA, whose latent cache decodes in
    ``models/mla.py``, and a recurrent-only stack, which has no
    attention to fuse).  The engine labels its ``engine.kernel_path``
    counter with it, so a silent fall-off the fused path shows in
    ``metrics_text()``."""
    if cfg.use_mla or "attn" not in cfg.layer_kinds():
        return "fallback"
    return "fused" if paging.use_fused_decode(cfg, flags) else "fallback"


def _mask_tok(tok: torch.Tensor, active: torch.Tensor,
              pad_id: int) -> torch.Tensor:
    """Inactive slots emit ``pad_id``."""
    shape = (-1,) + (1,) * (tok.ndim - 1)
    return torch.where(active.reshape(shape), tok,
                       torch.full_like(tok, pad_id))


def make_serve_decode_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS,
                           pad_id: int = 0, masked_state: bool = False):
    """Decode one token for every slot of a continuous batch: ``positions``
    is a [N] vector of per-slot cache offsets and ``active`` a [N] bool
    mask.  Inactive slots still flow through the step (every row op is
    row-independent, so they cannot perturb active rows, and a later
    insert overwrites the whole row) but emit ``pad_id``.  A paged or
    hybrid cache passes ``block_tables`` ([N, P] int32; inactive rows all
    zero, so their writes land in the trash block 0); the layout
    difference is entirely inside the model's block-table seam.

    ``masked_state`` (the state and hybrid layouts) passes ``active`` as
    the model's ``state_mask``: recurrent mixers overwrite their whole
    state every step, so without it a decode tick would destroy the
    ingest-frontier state of rows mid chunked prefill."""
    def serve_decode_step(tokens, cache, positions, active,
                          block_tables=None):
        logits, cache = model.decode_step(
            tokens, cache, positions, flags=flags,
            block_tables=block_tables,
            state_mask=active if masked_state else None)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return _mask_tok(tok, active, pad_id), cache

    return serve_decode_step


def make_verify_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS,
                     pad_id: int = 0):
    """Speculative verification: score a ``[N, 1+k]`` window per slot in
    one pass and return the greedy argmax at every window position.
    Window token ``s`` attends under ``idx <= pos + s``, exactly what
    ``1+k`` successive one-token decode steps compute.  Rejected tail
    writes are rolled back by the scheduler/backend (``positions``
    rewind + paged ``truncate``)."""
    def verify_step(tokens, cache, positions, active, block_tables=None):
        logits, cache = model.decode_step(tokens, cache, positions,
                                          flags=flags, all_logits=True,
                                          block_tables=block_tables)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return _mask_tok(tok, active, pad_id), cache

    return verify_step


def slot_batch_axis(path) -> int:
    """Axis of the slot (batch) dimension in a cache leaf: scanned-block
    leaves are [R, B, ...], so 1 under the top-level ``"blocks"`` key,
    0 everywhere else."""
    return 1 if (path and path[0] == "blocks") else 0


def _leaves(cache, rows):
    """(axis of the batch dim, cache leaf, rows leaf) for every leaf."""
    src = flatten(rows)
    for path, big in flatten(cache).items():
        yield slot_batch_axis(path.split(".")), big, src[path]


def make_slot_insert():
    """Build ``insert(cache, rows, row, slot)``: copy cache row ``row`` of
    a freshly prefilled batch into slot ``slot`` of the persistent slot
    cache, in place."""
    def insert(cache, rows, row: int, slot: int):
        for ax, big, r in _leaves(cache, rows):
            big.select(ax, slot).copy_(r.select(ax, row))
        return cache

    return insert


def _scatter_pages(block_size: int, big: torch.Tensor, r: torch.Tensor,
                   ax: int, ids: torch.Tensor) -> None:
    """Write one cache row ``r`` (``[R, S, ...]`` under ``"blocks"``,
    else ``[S, ...]``) into arena leaf ``big`` page by page, in place:
    page ``j`` to block ``ids[j]``."""
    if ax == 1:                         # scanned blocks: [R, S, ...]
        pages = r.reshape((r.shape[0], -1, block_size) + r.shape[2:])
        big[:, ids] = pages.to(big.dtype)
    else:                               # head layers: [S, ...]
        big[ids] = r.reshape((-1, block_size) + r.shape[1:]).to(big.dtype)


def _offsets(block_size: int, loc: int, r: torch.Tensor, ax: int,
             tp) -> torch.Tensor:
    """A whole row ``r`` (positions on axis ``ax``) cut to the positions
    a sequence-cut arena of a tensor-parallel rank holds: its ``loc``
    offsets ``[rank loc, (rank + 1) loc)`` of every block."""
    P = r.shape[ax] // block_size
    pages = r.reshape(r.shape[:ax] + (P, block_size) + r.shape[ax + 1:])
    return pages.narrow(ax + 1, tp.rank * loc, loc).reshape(
        r.shape[:ax] + (P * loc,) + r.shape[ax + 1:])


def _whole_rows(rows, rows_len: int, tp):
    """The row leaves of ``rows`` ({path: (ax, leaf)}), those whose
    positions a tensor-parallel rank holds a contiguous cut of (a
    prefill's rows, ``rules.cache_specs``) made whole, ``rows_len``
    long, in one exact all-reduce."""
    out = {p: r for p, (ax, r) in rows.items()}
    if tp is None:
        return out
    cut = {p: placed(r, ax, own_range(r.shape[ax], tp, r.device), rows_len)
           for p, (ax, r) in rows.items() if r.shape[ax] < rows_len}
    if cut:
        out.update(zip(cut, tp_reduce_parts(list(cut.values()), tp)))
    return out


def _paged_scatter_rows(block_size: int, arena, rows, row: int,
                        page_ids: torch.Tensor, tp=None, only=None):
    """Scatter one prefilled cache row (``[B, S_cache, ...]``, ``S_cache``
    a multiple of ``block_size``) into the paged arena, page by page, in
    place.

    ``page_ids`` is a [S_cache / block_size] vector: entry ``j`` is the
    arena block receiving the row's ``j``-th page, or 0 (the trash
    block) for pages that must not land anywhere: padding beyond the
    prompt, and pages already present as shared prefix blocks (shared
    blocks are immutable; redirecting their writes to the trash block
    preserves that).  Every 0 entry writes block 0, so block 0 receives
    duplicate writes whose order ``index_put_`` leaves undefined on
    CUDA: harmless only because block 0 is never read unmasked.

    On a tensor-parallel rank (``tp``) an arena cut on its positions
    holds its offsets of every block: the row, whole or (a prefill's
    rows) the rank's contiguous cut gathered whole first, is cut to
    them.  ``only`` ({path}) limits the write to those leaves."""
    ids = page_ids.long()
    src = flatten(rows)
    todo = {path: (slot_batch_axis(path.split(".")), big)
            for path, big in flatten(arena).items()
            if only is None or path in only}
    whole = _whole_rows({path: (ax, src[path].select(ax, row))
                         for path, (ax, big) in todo.items()},
                        len(ids) * block_size, tp)
    for path, (ax, big) in todo.items():
        r, loc = whole[path], big.shape[ax + 1]     # positions a block holds
        if loc < block_size:
            r = _offsets(block_size, loc, r, ax, tp)
        _scatter_pages(loc, big, r, ax, ids)
    return arena


def make_paged_insert(block_size: int, tp=None):
    """Build ``insert(arena, rows, row, page_ids)`` — see
    :func:`_paged_scatter_rows`; ``tp``: a tensor-parallel rank's
    group."""
    return functools.partial(_paged_scatter_rows, block_size, tp=tp)


def _write_positions(dst: torch.Tensor, src: torch.Tensor, offset: int,
                     dim: int, tp) -> None:
    """Write ``src``, positions ``offset ..`` on ``dim``, into ``dst``
    holding a tensor-parallel rank's contiguous cut ``[r M, (r + 1) M)``
    of the positions, in place: the positions that fall in it."""
    M, S = dst.shape[dim], src.shape[dim]
    lo = max(offset, tp.rank * M)
    hi = min(offset + S, (tp.rank + 1) * M)
    if hi > lo:
        dst.narrow(dim, lo - tp.rank * M, hi - lo).copy_(
            src.narrow(dim, lo - offset, hi - lo))


def _slot_write_rows(cache, rows, slot: int, offset: int, seq_cut=None,
                     tp=None):
    """Write batch-1 suffix rows (the suffix unpadded) into slot ``slot``
    at sequence offset ``offset``, in place — the chunked-prefill insert
    of the contiguous layout.  On a tensor-parallel rank a leaf
    ``seq_cut(path)`` names holds the rank's contiguous cut of the
    positions, and the rows hold every position
    (:func:`_write_positions`)."""
    src = flatten(rows)
    for path, big in flatten(cache).items():
        ax = slot_batch_axis(path.split("."))
        r = src[path].select(ax, 0)
        dst = big.select(ax, slot)
        if seq_cut is not None and seq_cut(path):
            _write_positions(dst, r, offset, ax, tp)
        else:
            dst.narrow(ax, offset, r.shape[ax]).copy_(r)
    return cache


def make_extend_step(model: Model, prefix_len: int,
                     flags: RuntimeFlags = DEFAULT_FLAGS, *,
                     block_size: int = 0, max_cache_len: int = 0):
    """Chunked / prefix-shared prefill: compute only a prompt suffix
    against the request's cached prefix, write the suffix K/V back into
    its cache, and return the last position's next token (meaningful
    only when the suffix ends the prompt).

    ``block_size == 0`` builds the slot-layout step
    ``(tokens [1,S'], cache, slot) -> (tok [1], cache)`` that reads the
    prefix from, and writes the suffix into, contiguous slot row
    ``slot``; otherwise the paged step ``(tokens [1,S'], cache,
    table_row [P], page_ids [P]) -> (tok [1], cache)`` reads prefix
    pages through ``table_row`` and scatters suffix pages to the
    ``page_ids`` blocks (``prefix_len`` a multiple of ``block_size``)."""
    if block_size:
        if max_cache_len <= 0:
            raise ValueError("paged extend step needs max_cache_len "
                             "(rows must pad to whole pages)")

        def paged_extend_step(tokens, cache, table_row, page_ids):
            ref = paging.PagedPrefix(table_row[None], block_size)
            logits, rows = model.prefill_extend(
                tokens, cache, ref, prefix_len, max_cache_len, flags=flags)
            cache = _paged_scatter_rows(block_size, cache, rows, 0, page_ids,
                                        flags.tp)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        return paged_extend_step

    def slot_extend_step(tokens, cache, slot):
        ref = paging.SlotPrefix(slot[None])
        # max_cache_len == suffix length: rows come back unpadded, so the
        # write touches exactly [slot, prefix_len:prefix_len+S')
        logits, rows = model.prefill_extend(
            tokens, cache, ref, prefix_len, tokens.shape[1], flags=flags)
        cache = _slot_write_rows(cache, rows, int(slot), prefix_len,
                                 _seq_cut(model, flags), flags.tp)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return slot_extend_step


def _seq_cut(model: Model, flags: RuntimeFlags):
    """The predicate of the cache leaves a rank of ``flags.tp`` holds a
    cut of the positions of (``transformer.seq_cut``); None off a
    mesh."""
    if flags.tp is None:
        return None
    return functools.partial(tf.seq_cut, model.cfg, tp=flags.tp)


# ---------------------------------------------------------------------------
# state / hybrid layouts (recurrent mixers in O(1) state slabs)
# ---------------------------------------------------------------------------

def make_state_verify_step(model: Model, flags: RuntimeFlags = DEFAULT_FLAGS,
                           pad_id: int = 0):
    """:func:`make_verify_step` for the state and hybrid layouts.

    Recurrent state cannot be rolled back by rewinding a position, so
    the window pass leaves every state slab *uncommitted* and writes the
    state after each window position, for every slot, into ``stacks``
    (buffers of ``Model.new_state_stacks``, in place); the backend's
    ``truncate`` commits the accepted prefix's entry through
    :func:`make_state_rewind`.  Attention caches (slot rows, or the
    hybrid's arena through ``block_tables``) are written as usual: their
    rejected tail rolls back by position rewind and page truncate.
    Returns (guess [N, 1+k], cache, stacks)."""
    def state_verify_step(tokens, cache, positions, active,
                          block_tables=None, *, stacks):
        logits, cache, stacks = model.decode_step(
            tokens, cache, positions, flags=flags, all_logits=True,
            block_tables=block_tables, want_state_stacks=True,
            stacks=stacks)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return _mask_tok(tok, active, pad_id), cache, stacks

    return state_verify_step


def make_state_rewind():
    """Build ``rewind(cache, stacks, slot, idx)``: commit the state after
    window position ``idx`` (0-based within the verify window) of row
    ``slot`` from the stacks a state verify step wrote, in place.
    State-slab leaves take ``stack[slot, idx]``; attention leaves (their
    stacks are zero-size placeholders) are left as they are."""
    def rewind(cache, stacks, slot: int, idx: int):
        for ax, live, stk in _leaves(cache, stacks):
            if stk.numel() == 0:
                continue
            live.select(ax, slot).copy_(stk.select(ax, slot).select(ax, idx))
        return cache

    return rewind


def _state_write_rows(model: Model, cache, rows, slot: int, offset: int,
                      seq_cut=None, tp=None):
    """Chunked-prefill write-back on the state layout, in place:
    attention leaves (mixed stacks keep contiguous slot rows there)
    write the batch-1 suffix rows at ``[slot, offset:offset + S')``;
    recurrent leaves overwrite slab row ``slot`` with the state after
    the chunk — the slab row is the ingest-frontier checkpoint.  A
    tensor-parallel rank writes the attention positions it holds, as
    :func:`_slot_write_rows` does."""
    src = flatten(rows)
    for path, big in flatten(cache).items():
        ax = slot_batch_axis(path.split("."))
        r = src[path].select(ax, 0)
        dst = big.select(ax, slot)
        if model.layer_kind_of_path(path) == "attn":
            if seq_cut is not None and seq_cut(path):
                _write_positions(dst, r, offset, ax, tp)
                continue
            dst = dst.narrow(ax, offset, r.shape[ax])
        dst.copy_(r)
    return cache


def _hybrid_scatter_rows(model: Model, block_size: int, arena, rows,
                         row: int, page_ids: torch.Tensor, slot: int,
                         tp=None):
    """Hybrid-layout cache write, in place: attention leaves scatter the
    row's pages to the ``page_ids`` blocks (see
    :func:`_paged_scatter_rows`, ``tp`` as there); recurrent leaves copy
    batch row ``row`` of the prefilled states into slab row ``slot``."""
    src = flatten(rows)
    attn = set()
    for path, big in flatten(arena).items():
        if model.layer_kind_of_path(path) == "attn":
            attn.add(path)
        else:
            ax = slot_batch_axis(path.split("."))
            big.select(ax, slot).copy_(src[path].select(ax, row))
    _paged_scatter_rows(block_size, arena, rows, row, page_ids, tp,
                        only=attn)
    return arena


def make_hybrid_insert(model: Model, block_size: int, tp=None):
    """Build ``insert(arena, rows, row, page_ids, slot)`` — see
    :func:`_hybrid_scatter_rows`."""
    return functools.partial(_hybrid_scatter_rows, model, block_size, tp=tp)


def make_state_extend_step(model: Model, prefix_len: int,
                           flags: RuntimeFlags = DEFAULT_FLAGS, *,
                           block_size: int = 0, max_cache_len: int = 0):
    """:func:`make_extend_step` for the state and hybrid layouts:
    attention layers extend against their gathered prefix K/V as before,
    while recurrent layers *continue the sequential state scan* from
    their slab row, so the state after chunk k is bitwise that of a cold
    prefill of ``prompt[:end_k]``, wherever the chunk boundaries fall.

    ``block_size == 0`` builds the state-layout step ``(tokens [1,S'],
    cache, slot) -> (tok [1], cache)``; otherwise the hybrid step
    ``(tokens [1,S'], cache, table_row [P], page_ids [P], slot) ->
    (tok [1], cache)``."""
    if block_size:
        if max_cache_len <= 0:
            raise ValueError("hybrid extend step needs max_cache_len "
                             "(attention rows must pad to whole pages)")

        def hybrid_extend_step(tokens, cache, table_row, page_ids, slot):
            ref = paging.PagedPrefix(table_row[None], block_size)
            logits, rows = model.prefill_extend(
                tokens, cache, ref, prefix_len, max_cache_len, flags=flags,
                slots=slot[None])
            cache = _hybrid_scatter_rows(model, block_size, cache, rows, 0,
                                         page_ids, int(slot), flags.tp)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

        return hybrid_extend_step

    def state_extend_step(tokens, cache, slot):
        ref = paging.SlotPrefix(slot[None])
        logits, rows = model.prefill_extend(
            tokens, cache, ref, prefix_len, tokens.shape[1], flags=flags,
            slots=slot[None])
        cache = _state_write_rows(model, cache, rows, int(slot), prefix_len,
                                  _seq_cut(model, flags), flags.tp)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return state_extend_step
