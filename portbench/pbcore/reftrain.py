"""The plain reference of a training cell's first steps: the
configuration's next-token loss in float32 with plain PyTorch operations
(TF32 off), its gradients by autograd, the schedule's learning rate and
AdamW as the configuration states them, with the weights stored in the
configuration's dtype after each update (bfloat16: an update under half
a unit in the last place is lost, as it is in the program).

It imports nothing of the program.  It draws the weights from the seed
as the benchmark drew them for the program (``weights.py``) and the
batches as the program's were drawn (``batch``), so it reads nothing the
program made.  Each layer runs under an activation checkpoint and the
loss a block of rows at a time, so that its f32 state fits beside
nothing else on the card.

``quant="fp8"`` is the control: every product with a weight, forward and
backward, takes its operands rounded to fp8 e4m3 (activations and
gradients scaled per row, weights per output column), the step below
the bfloat16 that the configuration states.  ``half_batch`` is a fault:
the loss is the mean over the first half of each batch's rows.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .reference import fake_fp8, true_f32
from .weights import DTYPES, make_weights

P = "blocks.l0."
LAYER = ("norm1.scale", "mixer.wq", "mixer.wk", "mixer.wv", "mixer.wo",
         "norm2.scale", "ffn.w_gate", "ffn.w_up", "ffn.w_down")
#: AdamW as the configuration states it
ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}
#: rows of one block of the loss (bounds the f32 logits' memory)
CE_ROWS = 2048
#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone; its change is not compared
STILL = 1e-3


def batch(seed: int, i: int, rows: int, seq: int, vocab: int, device):
    """Step ``i``'s batch from ``seed``: ``rows`` sequences of ``seq``
    random tokens and their next tokens, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + 7 * int(i) + 1)
    toks = torch.randint(0, vocab, (rows, seq + 1), generator=gen,
                         device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def wsd(step: int, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, min_ratio: float = 0.01) -> torch.Tensor:
    """Warmup, a stable peak, and an exponential decay over the last
    ``decay_frac`` of ``total`` steps, in f32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    if step < warmup:
        return peak_lr * s / max(warmup, 1)
    start = total * (1.0 - decay_frac)
    if step < start:
        return torch.tensor(peak_lr, dtype=torch.float32)
    t = torch.clamp((s - start) / max(total - start, 1), 0.0, 1.0)
    return peak_lr * torch.exp(math.log(min_ratio) * t)


class _Fp8Linear(torch.autograd.Function):
    """x @ w with fp8 operands in the product and in both of its
    gradients' products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return fake_fp8(x, -1) @ fake_fp8(w, 0)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = fake_fp8(g, -1)
        gx = gq @ fake_fp8(w, 1).t()
        gw = fake_fp8(x, 0).t() @ fake_fp8(g, 0)
        return gx, gw


def leaf_name(key: str, layer: Optional[int]) -> str:
    return key if layer is None else f"{key}[{layer}]"


def split_leaves(tree: Dict[str, torch.Tensor], vocab: int):
    """``(name, tensor)`` of every leaf as the check compares them: a
    stacked layer leaf a layer at a time, the embedding over the real
    vocabulary."""
    for key, t in tree.items():
        if key.startswith(P):
            for layer in range(t.shape[0]):
                yield leaf_name(key, layer), t[layer]
        elif key == "embed.embedding":
            yield key, t[:vocab]
        else:
            yield key, t


def norms(pairs) -> Dict[str, float]:
    """The f32 norm of each ``(name, tensor)``, read in one copy."""
    names, vals = [], []
    for name, t in pairs:
        names.append(name)
        vals.append(torch.linalg.vector_norm(t.float()))
    return dict(zip(names, torch.stack(vals).tolist()))


class RefTrainer:
    """The checked steps of a training cell, from the weights of ``seed``
    (``vocab_rows`` embedding rows drawn, as for the program)."""

    def __init__(self, spec: Dict, mix: Dict, seed: int, device, *,
                 vocab_rows: int, quant: Optional[str] = None,
                 half_batch: bool = False):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        if mix["optimizer"] != "adamw" or mix["schedule"] != "wsd":
            raise ValueError("the reference trains with AdamW and WSD only")
        if spec.get("num_local_experts"):
            raise ValueError("the training reference has no MoE FFN")
        self.spec, self.mix, self.seed = spec, mix, int(seed)
        self.device = torch.device(device)
        self.quant, self.half = quant, half_batch
        self.V = spec["vocab_size"]
        self.vocab_rows = vocab_rows
        self.store = DTYPES[spec["dtype"]]

    # -- the model -----------------------------------------------------
    def linear(self, x, w):
        if self.quant == "fp8":
            lead = x.shape[:-1]
            return _Fp8Linear.apply(x.reshape(-1, x.shape[-1]), w) \
                .reshape(*lead, w.shape[-1])
        return x @ w

    def norm(self, x, scale):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.spec["rms_norm_eps"]) * scale

    def rope(self, x, pos):
        """x [B, S, n, hd] rotated at positions ``pos`` [S]."""
        hd = x.shape[-1]
        inv = 1.0 / (self.spec["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device)
            / hd))
        ang = (pos.to(torch.float64)[:, None] * inv)[:, None, :]
        cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def layer(self, x, n1, wq, wk, wv, wo, n2, wg, wu, wd):
        s = self.spec
        B, S, d = x.shape
        H, KV, hd = (s["num_attention_heads"], s["num_key_value_heads"],
                     s["head_dim"])
        pos = torch.arange(S, device=x.device)
        h = self.norm(x, n1)
        q = self.rope(self.linear(h, wq.reshape(d, H * hd))
                      .view(B, S, H, hd), pos)
        k = self.rope(self.linear(h, wk.reshape(d, KV * hd))
                      .view(B, S, KV, hd), pos)
        v = self.linear(h, wv.reshape(d, KV * hd)).view(B, S, KV, hd)
        G = H // KV
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        outs = []
        for b in range(B):
            kb = k[b].repeat_interleave(G, dim=1).transpose(0, 1)
            vb = v[b].repeat_interleave(G, dim=1).transpose(0, 1)
            sc = q[b].transpose(0, 1) @ kb.transpose(1, 2) / hd ** 0.5
            sc = sc.masked_fill(~keep, float("-inf"))
            outs.append((torch.softmax(sc, -1) @ vb).transpose(0, 1))
        att = torch.stack(outs).reshape(B, S, H * hd)
        x = x + self.linear(att, wo.reshape(H * hd, d))
        h = self.norm(x, n2)
        return x + self.linear(torch.nn.functional.silu(self.linear(h, wg))
                               * self.linear(h, wu), wd)

    def _ce(self, h, labels, scale, emb):
        logits = self.linear(self.norm(h, scale), emb.t())
        gold = logits.gather(1, labels[:, None])[:, 0]
        return (torch.logsumexp(logits, -1) - gold).sum()

    def loss(self, tokens, labels):
        p = self.p
        emb = p["embed.embedding"]
        x = emb[tokens]
        for layer in range(self.spec["num_hidden_layers"]):
            ws = [p[leaf_name(P + n, layer)] for n in LAYER]
            x = checkpoint(self.layer, x, *ws, use_reentrant=False)
        h = x.reshape(-1, x.shape[-1])
        y = labels.reshape(-1)
        total = 0.0
        for a in range(0, h.shape[0], CE_ROWS):
            total = total + checkpoint(
                self._ce, h[a:a + CE_ROWS], y[a:a + CE_ROWS],
                p["final_norm.scale"], emb, use_reentrant=False)
        return total / h.shape[0]

    # -- the steps -----------------------------------------------------
    def run(self, steps: int) -> Dict:
        """The readings of ``steps`` steps: each step's loss, each leaf's
        first gradient and its change after the last step."""
        w0 = make_weights(self.spec, self.seed, self.device,
                          vocab_rows=self.vocab_rows)
        self.p = {name: t.float().clone().requires_grad_(True)
                  for name, t in split_leaves(w0, self.V)}
        m = {k: torch.zeros_like(t) for k, t in self.p.items()}
        v = {k: torch.zeros_like(t) for k, t in self.p.items()}
        mix, a = self.mix, ADAMW
        rows, seq = int(mix["batch"]), int(mix["seq"])
        out: Dict = {"loss": []}
        for i in range(steps):
            b = batch(self.seed, i, rows, seq, self.V, self.device)
            tokens, labels = b["tokens"], b["labels"]
            if self.half:
                tokens, labels = tokens[:rows // 2], labels[:rows // 2]
            with true_f32():
                loss = self.loss(tokens, labels)
                loss.backward()
            out["loss"].append(float(loss.detach()))
            if i == 0:
                out["grad"] = norms((k, t.grad) for k, t in self.p.items())
            t = i + 1
            lr = wsd(t, peak_lr=mix["peak_lr"], warmup=int(mix["warmup"]),
                     total=int(mix["total_steps"])).to(self.device)
            c1, c2 = 1 - a["b1"] ** t, 1 - a["b2"] ** t
            with torch.no_grad():
                for k, p in self.p.items():
                    g = p.grad
                    m[k].mul_(a["b1"]).add_(g, alpha=1 - a["b1"])
                    v[k].mul_(a["b2"]).addcmul_(g, g, value=1 - a["b2"])
                    delta = (m[k] / c1) / (torch.sqrt(v[k] / c2) + a["eps"]) \
                        + a["weight_decay"] * p
                    p.copy_((p - lr * delta).to(self.store).float())
                    p.grad = None
        out["change"] = norms(
            (name, self.p[name].detach() - t0.float())
            for name, t0 in split_leaves(w0, self.V))
        del self.p, m, v, w0
        return out


def train_numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a training cell's check compares, of readings ``got``
    against the reference's ``ref``: the widest gap of a step's loss; of
    the first gradient's norm, leaf by leaf; and of the norm of a leaf's
    change after the checked steps, over the leaves whose reference
    gradient is at least ``STILL`` of the median leaf's.  A leaf's gap
    is measured against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    inf = {"loss_gap": math.inf, "grad_gap": math.inf,
           "update_gap": math.inf}
    if not got or len(got.get("loss", [])) != len(ref["loss"]):
        return inf

    def widest(a: Dict[str, float], r: Dict[str, float], names: List[str]):
        med = median(r[k] for k in names)
        out = 0.0
        for k in names:
            if k not in a or not math.isfinite(a[k]):
                return math.inf
            den = max(r[k], med)
            gap = abs(a[k] - r[k])
            out = max(out, gap / den if den > 0 else
                      (0.0 if gap == 0 else math.inf))
        return out

    loss = max(abs(x - y) if math.isfinite(x) else math.inf
               for x, y in zip(got["loss"], ref["loss"]))
    names = list(ref["grad"])
    gmed = median(ref["grad"].values())
    moved = [k for k in names if ref["grad"][k] >= STILL * gmed]
    return {"loss_gap": loss,
            "grad_gap": widest(got["grad"], ref["grad"], names),
            "update_gap": widest(got["change"], ref["change"], moved)}
