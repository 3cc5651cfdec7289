"""Tensor parallelism of the backbones: the Megatron layout written out.

Counterpart of ``sculptmate_tpu/ops/sharding.py``. There, modules annotate
their activations with sharding constraints over a ``tp`` mesh axis and
GSPMD inserts the collectives. Here the modules take a tp group (a tuple
of devices, one per shard; ``None`` runs unsharded) and this module does
what GSPMD did:

- a ``Linear`` whose outputs are attention heads or feed-forward hidden
  units is split by output rows (``column_shards``), one contiguous slice
  per shard; a GEGLU projection splits its ``h`` and ``gate`` halves alike,
  so each shard holds the same hidden units of both (as JAX's constraints
  on both halves ask);
- the projection after them is split by input columns (``row_shards``),
  each shard giving a partial product;
- ``reduce_partials`` sums the partials on the group's first device in
  fixed shard order, accumulating in f32, and adds the bias once.

Each module keeps its full ``nn.Linear`` parameters, so the state dict
and the checkpoint bridges do not change. A shard on the weight's own
device is a view of it; a shard on another device is copied there once and
kept on the ``Linear`` while its parameters (their storage and version
counters) stay the same, as K5's packed weights are kept.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sculptmate_tpu_torch.ops.attention import dot_product_attention
from sculptmate_tpu_torch.runtime.device import device_scope

TPGroup = Tuple[torch.device, ...]


def _kept(linear: torch.nn.Linear, key, build):
    """``build()``, kept on ``linear`` under ``key`` while its parameters
    stay the same; parameters made under inference mode keep no version
    counter and are split anew."""
    params = [p for p in (linear.weight, linear.bias) if p is not None]
    stamp = None
    if not any(p.is_inference() for p in params):
        stamp = tuple((p.data_ptr(), p._version) for p in params)
    cache = linear.__dict__.setdefault("_tp_shards", {})
    hit = cache.get(key)
    if stamp is None or hit is None or hit[0] != stamp:
        hit = (stamp, build())
        if stamp is not None:
            cache[key] = hit
    return hit[1]


def _split(n: int, tp: TPGroup, what: str) -> int:
    if n % len(tp):
        raise ValueError(f"{n} {what} do not split over tp = {len(tp)}")
    return n // len(tp)


def column_shards(linear: torch.nn.Linear, tp: TPGroup, parts: int = 1) -> List[List[tuple]]:
    """Per shard s, per part p of the output (``parts`` equal halves for a
    GEGLU projection): (weight rows, bias | None) of shard s's slice of part
    p, on ``tp[s]``."""
    n = _split(linear.out_features // parts, tp, "output units per part")

    def build():
        W, b = linear.weight, linear.bias
        out = []
        for s, dev in enumerate(tp):
            rows = [slice(p * n * len(tp) + s * n, p * n * len(tp) + (s + 1) * n) for p in range(parts)]
            out.append([(W[r].to(dev), None if b is None else b[r].to(dev)) for r in rows])
        return out

    return _kept(linear, ("columns", tp, parts), build)


def row_shards(linear: torch.nn.Linear, tp: TPGroup) -> List[torch.Tensor]:
    """Per shard s: the weight columns of its slice of the input, on
    ``tp[s]``; the bias is added once by ``reduce_partials``."""
    n = _split(linear.in_features, tp, "input units")
    return _kept(linear, ("rows", tp),
                 lambda: [linear.weight[:, s * n : (s + 1) * n].to(dev) for s, dev in enumerate(tp)])


def reduce_partials(parts: Sequence[torch.Tensor], bias: Optional[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' partial products on ``device``, in shard
    order, accumulated in f32, plus ``bias`` once, in the partials' dtype."""
    acc = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device, non_blocking=True)
    if bias is not None:
        acc = acc + bias
    return acc.to(parts[0].dtype)


def sharded_attention(x_q: torch.Tensor, x_kv: torch.Tensor, wq, wk, wv, proj, heads: int,
                      tp: TPGroup) -> torch.Tensor:
    """Multi-head attention with q, k and v split by heads (``heads /
    len(tp)`` per shard, each shard's attention one ``dot_product_attention``
    call: kernel K1 on the card) and the output projection ``proj`` split
    by rows, reduced on ``x_q``'s device. (B, Nq, C) -> (B, Nq, C)."""
    hs = _split(heads, tp, "attention heads")
    q_sh, k_sh, v_sh = (column_shards(w, tp) for w in (wq, wk, wv))
    o_sh = row_shards(proj, tp)
    B, Nq, _ = x_q.shape
    Nk = x_kv.shape[1]
    parts = []
    for s, dev in enumerate(tp):
        with device_scope(dev):
            xq = x_q.to(dev, non_blocking=True)
            xkv = xq if x_kv is x_q else x_kv.to(dev, non_blocking=True)
            q = F.linear(xq, *q_sh[s][0]).reshape(B, Nq, hs, -1)
            k = F.linear(xkv, *k_sh[s][0]).reshape(B, Nk, hs, -1)
            v = F.linear(xkv, *v_sh[s][0]).reshape(B, Nk, hs, -1)
            parts.append(F.linear(dot_product_attention(q, k, v).reshape(B, Nq, -1), o_sh[s]))
    return reduce_partials(parts, proj.bias, x_q.device)
