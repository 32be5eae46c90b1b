"""Graph-partitioned node sharding with a halo exchange: the node-sharded
sparse SpMM (counterpart of mpgcn_tpu/parallel/halo.py).

Nodes are partitioned into P contiguous row blocks of n_loc = N / P, one
a rank. Each rank holds its block of X and the padded-CSR rows it owns;
the only traffic between ranks is a HALO, the remote columns its rows
actually reference, moved by one ring round per offset that carries
traffic.

``build_halo_plan`` builds the plan in numpy from the concrete operator,
byte for byte the JAX package's: for every ring offset r, which of shard
q's local columns shard (q + r) % P needs, padded to one bucketed width a
round, and the operator's column ids remapped into [own block | halo
segments] space; rounds with no traffic anywhere are dropped. It also
splits each shard's rows into an OWN operator (the entries on its own
column block, independent of the exchange) and a HALO operator (the
rest, ids in halo-workspace space), and with ``local_impl='ell'`` packs
both as blocked-ELL containers. It sets the ``sparse_halo_bytes`` gauge
of the process registry (utils/flops.py ``halo_exchange_bytes``).

``halo_spmm`` runs on one rank of a world of P ranks (shard p = rank p,
the JAX package's flattened "node" axis): one ``batch_isend_irecv`` per
ring round that carries traffic, inside a ``torch.autograd.Function``
whose backward sends the received rows' cotangents back round the ring
the other way and scatter-adds them at the send indices. Its arms:

  * ``overlap=False``, ``local_impl='csr'``: the JAX reference, the full
    remapped operator applied to the [own | halo] workspace once the
    exchange has landed;
  * ``overlap=True``: the own-block product is issued while the exchange's
    requests are in flight, the halo remainder added once they land (the
    backward's reverse exchange is in flight while the own product's
    backward runs);
  * ``local_impl='ell'``: both local products run ``ell_spmm``
    (sparse/kernels.py), so ``ell_fwd`` launches forward and ``ell_bwd_dx``
    backward on the card (the halo operators are constants: no dBlocks);
    without ``overlap`` the own product waits for the exchange. (The JAX
    package takes its csr reference body whenever ``overlap`` is off.)
  * ``quantized=True``: every hop carries int8 codes plus one f32 scale a
    shard (amax / 127; an all-zero buffer gets scale 1), dequantized at
    the receiving end, both ways (the JAX ``_q_round``).

Gloo's P2P calls run on the host: a CUDA tensor is staged through host
memory for them (the SpMMs still run on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpgcn_tpu_torch.node_shard import staging_device
from mpgcn_tpu_torch.sparse.formats import (
    BlockedELL,
    PaddedCSR,
    ell_from_dense,
    plan_pad_width,
)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static exchange schedule and remapped local operators for P shards.

    local_indices: (P, K, n_loc, R) int32, halo-space column ids.
    local_values:  (P, K, n_loc, R).
    send_rounds:   tuple of (offset r, (P, S_r) int32 local column ids
                   each shard sends to shard (self + r) % P).
    own_* / halo_*: each row's own-block entries and its halo remainder,
                   compacted into two narrower bucketed operators (halo
                   ids in halo-workspace space: 0 = the first received
                   slot).
    ell_own / ell_halo: the same two operators as (P, K, ...) blocked-ELL
                   stacks (``local_impl='ell'`` plans only).
    """

    n_shards: int
    n_loc: int
    local_indices: torch.Tensor
    local_values: torch.Tensor
    send_rounds: Tuple[Tuple[int, torch.Tensor], ...]
    own_indices: torch.Tensor = None
    own_values: torch.Tensor = None
    halo_indices: torch.Tensor = None
    halo_values: torch.Tensor = None
    ell_own: Optional[BlockedELL] = None
    ell_halo: Optional[BlockedELL] = None

    @property
    def halo_cols(self) -> int:
        """Padded remote column slots each shard receives per exchange."""
        return sum(int(s.shape[1]) for _, s in self.send_rounds)

    def halo_width(self) -> int:
        return self.n_loc + self.halo_cols

    @property
    def device(self) -> torch.device:
        return self.local_indices.device

    def to(self, device) -> "HaloPlan":
        """The plan with its tensors on ``device`` (itself when there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, local_indices=mv(self.local_indices),
            local_values=mv(self.local_values),
            send_rounds=tuple((r, mv(s)) for r, s in self.send_rounds),
            own_indices=mv(self.own_indices), own_values=mv(self.own_values),
            halo_indices=mv(self.halo_indices),
            halo_values=mv(self.halo_values),
            ell_own=mv(self.ell_own), ell_halo=mv(self.ell_halo))


def _compact_rows(idx: np.ndarray, val: np.ndarray, live: np.ndarray,
                  bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compact the ``live`` entries of padded rows to the front and trim
    the pad width to a bucketed max (dead slots: index 0, value 0)."""
    width = plan_pad_width(int(live.sum(-1).max()) if live.any() else 0,
                           bucket)
    width = min(width, idx.shape[-1])
    order = np.argsort(~live, axis=-1, kind="stable")[..., :width]
    taken = np.take_along_axis(live, order, -1)
    v = np.where(taken, np.take_along_axis(val, order, -1), 0)
    i = np.where(taken, np.take_along_axis(idx, order, -1), 0)
    return i.astype(np.int32), v


def _split_dense(idx: np.ndarray, val: np.ndarray, live: np.ndarray,
                 n_cols: int) -> np.ndarray:
    """Scatter one split's (P, K, n_loc, R) padded rows into a dense
    (P, K, n_loc, n_cols) block (plan build only)."""
    lead = idx.shape[:-2]
    n_rows = idx.shape[-2]
    fi = np.where(live, idx, 0).reshape(-1, n_rows, idx.shape[-1])
    fv = np.where(live, val, 0).reshape(-1, n_rows, val.shape[-1])
    out = np.zeros((fi.shape[0], n_rows, n_cols), val.dtype)
    rows = np.arange(n_rows)[:, None]
    for b in range(fi.shape[0]):
        np.add.at(out[b], (rows, fi[b]), fv[b])
    return out.reshape(*lead, n_rows, n_cols)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def build_halo_plan(sp: PaddedCSR, n_shards: int, bucket: int = 8,
                    feature_width: int = 1, dtype_bytes: int = 4,
                    local_impl: str = "csr") -> HaloPlan:
    """Partition a static (K, N, R) padded-CSR operator stack over
    ``n_shards`` contiguous node blocks and schedule the halo exchange.
    One plan serves every application of the stack. ``local_impl='ell'``
    also packs the own/halo operators as blocked-ELL stacks."""
    idx = _np(sp.indices)
    val = _np(sp.values)
    if idx.ndim == 2:
        idx, val = idx[None], val[None]
    K, N, R = idx.shape
    if N % n_shards:
        raise ValueError(
            f"halo sharding needs the node count N ({N}) divisible by "
            f"the shard count ({n_shards})")
    n_loc = N // n_shards
    owner = idx // n_loc                                  # (K, N, R)
    live = val != 0

    # per (receiver p, source q): sorted unique local cols p needs from q
    req: List[dict] = []
    for p in range(n_shards):
        rows = slice(p * n_loc, (p + 1) * n_loc)
        need: dict = {}
        cols = idx[:, rows][live[:, rows]]
        own = owner[:, rows][live[:, rows]]
        for q in range(n_shards):
            if q == p:
                continue
            c = np.unique(cols[own == q])
            if c.size:
                need[q] = c - q * n_loc                   # q-local ids
        req.append(need)

    # ring rounds: at offset r, shard q sends to (q + r) % P what that
    # shard requested of q; widths padded to one bucketed max per round
    send_rounds: List[Tuple[int, np.ndarray]] = []
    recv_base: List[dict] = [dict() for _ in range(n_shards)]
    halo_off = n_loc
    for r in range(1, n_shards):
        widths = [req[(q + r) % n_shards].get(q, np.empty(0, int)).size
                  for q in range(n_shards)]
        if max(widths) == 0:
            continue
        S = plan_pad_width(max(widths), bucket)
        sidx = np.zeros((n_shards, S), np.int32)
        for q in range(n_shards):
            c = req[(q + r) % n_shards].get(q)
            if c is not None:
                sidx[q, :c.size] = c
        send_rounds.append((r, sidx))
        for p in range(n_shards):
            q = (p - r) % n_shards
            c = req[p].get(q)
            if c is not None:
                # halo slot of q-local col j = halo_off + its position
                recv_base[p].update(
                    {q * n_loc + int(g): halo_off + j
                     for j, g in enumerate(c)})
        halo_off += S

    # remap column ids into [own block | halo] space; dead (pad) slots
    # point at local slot 0 with value 0
    remapped = np.zeros((n_shards, K, n_loc, R), np.int32)
    values = np.zeros((n_shards, K, n_loc, R), val.dtype)
    for p in range(n_shards):
        rows = slice(p * n_loc, (p + 1) * n_loc)
        bi, bv = idx[:, rows], val[:, rows]
        out = np.zeros_like(bi)
        local = (bi // n_loc) == p
        out[local] = bi[local] - p * n_loc
        remote = (~local) & (bv != 0)
        lut = recv_base[p]
        out[remote] = [lut[int(g)] for g in bi[remote]]
        remapped[p] = np.where(bv != 0, out, 0)
        values[p] = bv

    # own/halo split: each row's own-block entries and its halo remainder
    # compacted into two narrower bucketed operators
    live = values != 0
    own_live = live & (remapped < n_loc)
    halo_live = live & (remapped >= n_loc)
    own_i, own_v = _compact_rows(remapped, values, own_live, bucket)
    halo_i, halo_v = _compact_rows(remapped - n_loc, values, halo_live,
                                   bucket)
    halo_cols = halo_off - n_loc
    ell_own = ell_halo = None
    if local_impl == "ell":
        def as_ell(i, v, lv, n_cols):
            n_cols = max(int(n_cols), 1)
            bc = 128 if n_cols >= 128 else max(8, -(-n_cols // 8) * 8)
            return ell_from_dense(_split_dense(i, v, lv, n_cols), bc=bc)

        ell_own = as_ell(own_i, own_v, own_v != 0, n_loc)
        ell_halo = as_ell(halo_i, halo_v, halo_v != 0, halo_cols)
    elif local_impl != "csr":
        raise ValueError(f"unknown local_impl {local_impl!r}: "
                         f"expected 'csr' or 'ell'")
    t = torch.from_numpy
    plan = HaloPlan(
        n_shards=n_shards, n_loc=n_loc,
        local_indices=t(remapped), local_values=t(values),
        send_rounds=tuple((r, t(s)) for r, s in send_rounds),
        own_indices=t(own_i), own_values=t(np.ascontiguousarray(own_v)),
        halo_indices=t(halo_i), halo_values=t(np.ascontiguousarray(halo_v)),
        ell_own=ell_own, ell_halo=ell_halo)
    _set_halo_gauge(plan, feature_width, dtype_bytes)
    return plan


def _set_halo_gauge(plan: HaloPlan, feature_width: int, dtype_bytes: int):
    """Publish the per-exchange halo traffic into the process registry."""
    from mpgcn_tpu_torch.obs.metrics import default_registry
    from mpgcn_tpu_torch.utils.flops import halo_exchange_bytes

    default_registry().gauge(
        "sparse_halo_bytes", "bytes moved per halo exchange across all "
        "shards (node-sharded sparse SpMM, parallel/halo.py)").set(
        halo_exchange_bytes(plan.halo_cols, plan.n_shards,
                            feature_width, dtype_bytes))


# --- the exchange -------------------------------------------------------------


def _quantize(buf: torch.Tensor):
    """Symmetric int8 with ONE f32 scale for the whole buffer (amax / 127;
    an all-zero buffer gets scale 1, so 0/0 cannot poison the ring)."""
    f = buf.float()
    amax = f.abs().max() if f.numel() else f.new_zeros(())
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).reshape(1)
    codes = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return codes, scale


class _Ring:
    """One halo exchange on this rank: the rounds' sends and receives in
    flight (``start`` / ``finish``), and the reverse exchange of the
    cotangents (``start_reverse`` / ``finish_reverse``)."""

    def __init__(self, sends: tuple, offsets: tuple, rank: int, P: int,
                 quantized: bool):
        self.sends, self.offsets = sends, offsets
        self.rank, self.P, self.quantized = rank, P, quantized
        self._pending = None

    @staticmethod
    def _stage(t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().to(staging_device(t, None))

    def _post(self, bufs: list, forward: bool):
        """Send ``bufs[i]`` round i's way (forward: to rank + r, else to
        rank - r) and post the matching receives; returns (works, recv
        buffers, device, dtype)."""
        ops, recv = [], []
        device, dtype = bufs[0].device, bufs[0].dtype
        for i, (r, buf) in enumerate(zip(self.offsets, bufs)):
            dst = (self.rank + r) % self.P if forward else \
                (self.rank - r) % self.P
            src = (self.rank - r) % self.P if forward else \
                (self.rank + r) % self.P
            parts = _quantize(buf) if self.quantized else (buf,)
            got = []
            for j, part in enumerate(parts):
                out = self._stage(part)
                ops.append(dist.P2POp(dist.isend, out, dst,
                                      tag=2 * i + j))
                into = torch.empty_like(out)
                ops.append(dist.P2POp(dist.irecv, into, src,
                                      tag=2 * i + j))
                got.append(into)
            recv.append(got)
        works = dist.batch_isend_irecv(ops) if ops else []
        return works, recv, device, dtype

    def _landed(self, pending) -> list:
        works, recv, device, dtype = pending
        for w in works:
            w.wait()
        out = []
        for got in recv:
            if self.quantized:
                codes, scale = (g.to(device) for g in got)
                out.append((codes.float() * scale).to(dtype))
            else:
                out.append(got[0].to(device))
        return out

    def start(self, x_loc: torch.Tensor) -> None:
        self._shape = x_loc.shape
        self._pending = self._post([x_loc.index_select(0, s)
                                    for s in self.sends], True)

    def finish(self) -> list:
        pending, self._pending = self._pending, None
        return self._landed(pending)

    def start_reverse(self, grads: list) -> None:
        self._pending = self._post(grads, False)

    def finish_reverse(self) -> torch.Tensor:
        pending, self._pending = self._pending, None
        got = self._landed(pending)
        dx = got[0].new_zeros(self._shape)
        for s, g in zip(self.sends, got):
            dx.index_add_(0, s, g)
        return dx


class _Start(torch.autograd.Function):
    """x_loc -> a token; posts the exchange. Backward: waits for the
    reverse exchange and returns the scatter-added cotangent of x_loc."""

    @staticmethod
    def forward(ctx, x_loc, ring):
        ctx.ring = ring
        ring.start(x_loc.detach())
        return x_loc.new_zeros(0)

    @staticmethod
    def backward(ctx, _token):
        return ctx.ring.finish_reverse(), None


class _Finish(torch.autograd.Function):
    """token -> the received halo rows, one tensor a round. Backward:
    posts the cotangents of the received rows back round the ring."""

    @staticmethod
    def forward(ctx, token, ring):
        ctx.ring = ring
        ctx.shapes = [(int(s.shape[0]),) for s in ring.sends]
        return tuple(ring.finish())

    @staticmethod
    def backward(ctx, *grads):
        ctx.ring.start_reverse(list(grads))
        return torch.zeros(0, device=grads[0].device), None


def _csr(indices, values, X, n_cols: int) -> torch.Tensor:
    """A (K, n_loc, R) padded-CSR operator applied to X (n_cols, F)."""
    from mpgcn_tpu_torch.sparse.kernels import csr_spmm

    return csr_spmm(PaddedCSR(indices, values, n_cols), X)


def halo_spmm(plan: HaloPlan, X_loc: torch.Tensor, mesh=None,
              overlap: bool = False, local_impl: str = "csr",
              quantized: bool = False) -> torch.Tensor:
    """Node-sharded sparse SpMM on this rank: out[k, m] = sum_n A[k, m, n]
    X[n] for this rank's rows m, X_loc (n_loc, F) its block of X, with
    ONE halo exchange. Returns (K, n_loc, F). The ring spans the world of
    the default process group (``mesh``, where given, is one over that
    world: its rank is the shard). Arms and their arithmetic: the module
    docstring."""
    P = plan.n_shards
    world = dist.get_world_size() if dist.is_initialized() else 1
    size = mesh.world if mesh is not None else world
    if size != P:
        raise ValueError(
            f"plan was built for {P} shards but the mesh has {size} "
            f"devices")
    if local_impl not in ("csr", "ell"):
        raise ValueError(f"unknown local_impl {local_impl!r}: "
                         f"expected 'csr' or 'ell'")
    if local_impl == "ell" and plan.ell_own is None:
        raise ValueError(
            "plan has no blocked-ELL split: build it with "
            "build_halo_plan(..., local_impl='ell')")
    if X_loc.shape[0] != plan.n_loc:
        raise ValueError(f"X_loc has {X_loc.shape[0]} rows, not the plan's "
                         f"{plan.n_loc}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    plan = plan.to(X_loc.device)
    offsets = tuple(r for r, _ in plan.send_rounds)
    halo = []
    if offsets:
        ring = _Ring(tuple(s[rank].long() for _, s in plan.send_rounds),
                     offsets, rank, P, quantized)
        token = _Start.apply(X_loc, ring)
    if local_impl == "csr" and not overlap:
        if offsets:
            halo = list(_Finish.apply(token, ring))
        Xh = torch.cat([X_loc] + halo, dim=0)
        return _csr(plan.local_indices[rank], plan.local_values[rank], Xh,
                    plan.halo_width())
    if not overlap and offsets:
        halo = list(_Finish.apply(token, ring))
    if local_impl == "ell":
        from mpgcn_tpu_torch.sparse.kernels import ell_spmm

        own = ell_spmm(plan.ell_own[rank], X_loc)
    else:
        own = _csr(plan.own_indices[rank], plan.own_values[rank], X_loc,
                   plan.n_loc)
    if not offsets:
        return own
    if overlap:
        halo = list(_Finish.apply(token, ring))
    Xh = torch.cat(halo, dim=0)                        # (halo_cols, F)
    if local_impl == "ell":
        rest = ell_spmm(plan.ell_halo[rank], Xh)
    else:
        rest = _csr(plan.halo_indices[rank], plan.halo_values[rank], Xh,
                    plan.halo_cols)
    return own + rest
