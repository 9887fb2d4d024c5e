"""The kernels' route for DTensor inputs: each op runs on the local shards
through ``torch.distributed.tensor.experimental.local_map``.

The placements come from the model's hint sites
(:mod:`repro_torch.parallel.annotate`).  Per mesh dim the route accepts
the layouts in which the op's work splits into independent local pieces,
and calls the op itself (``ops.*``) on the local tensors: on the card the
hand-written kernel runs on the shard, on the CPU the plain version, on
``meta`` the fake of :mod:`.meta`.  What it accepts, per mesh dim:

* flash attention: q and k/v alike replicated, batch-sharded or
  head-sharded; q head-sharded over k/v replicated (GQA: each rank slices
  the kv heads its query heads read, which needs the shard boundaries to
  fall on whole groups, or inside one group); q sequence-sharded over k/v
  replicated (each rank's query rows sit at ``q_offset`` plus its shard's
  start and see the whole K/V).  A k/v gradient that the ranks compute in
  parts comes back ``Partial`` and is summed by DTensor.
* flash attention over k/v sharded on their sequence (``seq_parallel``'s
  ``seq`` rule at the k/v hint sites).  A causal, windowed or
  differentiated call gathers k and v over the mesh dims that shard their
  sequence, as XLA does for JAX's ``pallas_call``, and then takes one of
  the layouts above: a causal query shard must see every key before it,
  which lie on other ranks, and its window may cross a shard boundary.
  The gather is a DTensor redistribute, so autograd returns dK and dV
  to k/v's placement as a reduce-scatter of the ranks' partial sums.
  Non-causal attention without gradients (cross-attention decoding its
  image cache) does not gather: each rank attends to its keys with the
  forward kernel, which also returns the log-sum-exp, and three
  all-reduces a dim merge the shards (the query is first gathered over
  those dims).
* rmsnorm: any layout that keeps the last dim whole, with the scale
  replicated (its gradient is summed over the sharded rows).
* decode attention: as flash for batch and heads; a cache sharded over its
  sequence (the flash-decoding layout of ``cache_spec``) is not gathered:
  the query (one token) is gathered over those dims, each rank runs the
  decode kernel on its positions with lengths made relative to its shard
  and the kernel's log-sum-exp output (``ops.decode_attention_lse``; the
  plain version on the CPU, the fake on ``meta``), and the shards merge as
  the image cache's do.  A shard with no live key (past a sequence's
  length, or before its window) has log-sum-exp -inf and weight 0.
* the SSD scan: x batch- or head-sharded; dt, a, d follow the heads; B, C
  (shared by the heads) replicated, their gradients summed.

Any other layout raises ``NotImplementedError``: beyond k/v's sequence
above, the route gathers no sharded operand to make the op's work fit.
An input that is ``Partial`` (an unreduced sum, such as a row-parallel
matmul's output) is reduced first, an all-reduce the op's value needs in
any layout.  Outputs come back as DTensors in the query's (or x's)
placements.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map


def any_dtensor(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def _refuse(op: str, why: str):
    raise NotImplementedError(
        f"{op} on DTensors: {why}; the route runs the op on local shards "
        f"only and gathers no sharded operand")


def _prepare(t, mesh):
    """``t`` as a DTensor on ``mesh`` (a plain tensor is taken as
    replicated) with any Partial placement reduced."""
    if not isinstance(t, DTensor):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    if any(p.is_partial() for p in t.placements):
        return t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                     for p in t.placements])
    return t


def _offset(t: DTensor, dim: int) -> int:
    """Global index of the first element of this rank's shard on ``dim``."""
    _, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                   t.placements)
    return off[dim]


def _local_size(t: DTensor, dim: int) -> int:
    shape, _ = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                     t.placements)
    return shape[dim]


def _to(t: DTensor, placements) -> DTensor:
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def _unsharded(t: DTensor, dims) -> tuple:
    """t's placements with the mesh dims ``dims`` replicated."""
    return tuple(Replicate() if i in dims else p
                 for i, p in enumerate(t.placements))


def _kv_slice(op: str, q: DTensor, k: DTensor) -> tuple[int, int]:
    """The range of k's local heads that this rank's query heads read."""
    h, kv = q.shape[2], k.shape[2]
    g = h // kv
    h0, hl = _offset(q, 2), _local_size(q, 2)
    k0, kl = _offset(k, 2), _local_size(k, 2)
    if hl >= g:
        if h0 % g or hl % g:
            _refuse(op, f"{hl} query heads a shard from {h0} cut a group of "
                        f"{g}")
    elif g % hl or h0 % hl:
        _refuse(op, f"{hl} query heads a shard from {h0} straddle groups "
                    f"of {g}")
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    if lo < k0 or hi > k0 + kl:
        _refuse(op, "the kv heads a shard's queries read lie on another "
                    "rank")
    return lo - k0, hi - k0


def _attention_layout(op: str, qpl, kpl, *, decode: bool):
    """k's gradient placements for the placements ``qpl`` of q and ``kpl``
    of k, or refuse."""
    grads = []
    for pq, pk in zip(qpl, kpl):
        if pq == pk and (pq.is_replicate() or pq == Shard(0)
                         or pq == Shard(2)):
            grads.append(pk)
        elif pk.is_replicate() and pq == Shard(2):
            grads.append(Partial())
        elif pk.is_replicate() and pq == Shard(1) and not decode:
            grads.append(Partial())
        else:
            _refuse(op, f"q placed {pq} over k/v placed {pk}")
    return tuple(grads)


def _merge(o, lse, seq_dims, mesh):
    """Merge per-shard attention outputs ``o`` (B,S,H,hd) with their
    log-sum-exps ``lse`` (B,H,S) over the mesh dims ``seq_dims`` that
    shard the keys: three all-reduces a dim.  Returns o in fp32."""
    o = o.float()
    for i in seq_dims:
        grp = mesh.get_group(i)
        top = funcol.all_reduce(lse, "max", grp)
        w = torch.exp(lse - top)                           # (B,H,S)
        o = funcol.all_reduce(o * w.transpose(1, 2)[..., None], "sum", grp)
        tot = funcol.all_reduce(w, "sum", grp)
        o = o / tot.transpose(1, 2)[..., None]
        lse = top + torch.log(tot)
    return o


def flash_attention(fn, q, k, v, *, causal, window, softcap, scale,
                    q_offset):
    op = "flash_attention"
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q, k, v = (_prepare(t, mesh) for t in (q, k, v))
    if k.placements != v.placements:
        _refuse(op, f"k placed {k.placements}, v {v.placements}")
    seq_dims = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    if seq_dims:
        from repro_torch.kernels import ops
        if not (causal or window or ops._records(q, k, v)):
            return _flash_over_key_shards(q, k, v, seq_dims, softcap=softcap,
                                          scale=scale, q_offset=q_offset)
        # every key a causal (or windowed) query shard sees, and dK, dV
        # back as a reduce-scatter: an all-gather over k/v's sequence dims
        k = _to(k, _unsharded(k, seq_dims))
        v = _to(v, _unsharded(v, seq_dims))
    grads = _attention_layout(op, q.placements, k.placements, decode=False)
    lo, hi = _kv_slice(op, q, k)
    q_start = q_offset + _offset(q, 1)
    whole = (lo, hi) == (0, _local_size(k, 2))

    def local(ql, kl, vl):
        if not whole:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl, causal=causal, window=window, softcap=softcap,
                  scale=scale, q_offset=q_start)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     in_grad_placements=(q.placements, grads, grads),
                     device_mesh=mesh)(q, k, v)


def _flash_over_key_shards(q, k, v, seq_dims, *, softcap, scale, q_offset):
    """Non-causal attention without gradients (cross-attention decoding
    its image cache) over k/v sharded on their sequence: each rank attends
    to its keys with the forward kernel, which also returns the
    log-sum-exp, and :func:`_merge` combines the shards.  The query is
    gathered over those dims first."""
    op = "flash_attention"
    from repro_torch.kernels import ops
    mesh = q.device_mesh
    q = _to(q, _unsharded(q, seq_dims))
    _attention_layout(op, q.placements, _unsharded(k, seq_dims),
                      decode=True)
    lo, hi = _kv_slice(op, q, k)
    whole = (lo, hi) == (0, _local_size(k, 2))

    def merged(ql, kl, vl):
        if not whole:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        o, lse = ops.flash_attention_lse(ql, kl, vl, causal=False,
                                         window=None, softcap=softcap,
                                         scale=scale, q_offset=q_offset)
        return _merge(o, lse, seq_dims, mesh).to(ql.dtype)

    return local_map(merged, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     device_mesh=mesh)(q, k, v)


def rmsnorm(fn, x, scale, *, eps, zero_centered):
    op = "rmsnorm"
    mesh = (x if isinstance(x, DTensor) else scale).device_mesh
    x, scale = _prepare(x, mesh), _prepare(scale, mesh)
    if any(p.is_shard(x.ndim - 1) for p in x.placements):
        _refuse(op, "the normalised (last) dim is sharded")
    if not all(p.is_replicate() for p in scale.placements):
        _refuse(op, f"the scale is placed {scale.placements}")
    grads = tuple(Partial() if p.is_shard() else Replicate()
                  for p in x.placements)
    return local_map(
        lambda xl, sl: fn(xl, sl, eps=eps, zero_centered=zero_centered),
        out_placements=list(x.placements),
        in_placements=(x.placements, scale.placements),
        in_grad_placements=(x.placements, grads),
        device_mesh=mesh)(x, scale)


def decode_attention(fn, q, k, v, *, lengths, window, softcap, scale):
    op = "decode_attention"
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q, k, v = (_prepare(t, mesh) for t in (q, k, v))
    if k.placements != v.placements:
        _refuse(op, f"k placed {k.placements}, v {v.placements}")
    seq_dims = [i for i, p in enumerate(k.placements) if p == Shard(1)]
    if seq_dims:
        # the query (one token) whole over the cache's sequence dims
        q = _to(q, _unsharded(q, seq_dims))
    _attention_layout(op, q.placements, _unsharded(k, seq_dims),
                      decode=True)
    lo, hi = _kv_slice(op, q, k)
    whole = (lo, hi) == (0, _local_size(k, 2))
    # lengths follow the batch's placements
    lengths = _to(_prepare(lengths, mesh),
                  [Shard(0) if p == Shard(0) else Replicate()
                   for p in q.placements])
    t0 = _offset(k, 1)

    if not seq_dims:
        def local(ql, kl, vl, ll):
            if not whole:
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
            return fn(ql, kl, vl, lengths=ll, window=window,
                      softcap=softcap, scale=scale)

        return local_map(local, out_placements=list(q.placements),
                         in_placements=(q.placements, k.placements,
                                        v.placements, lengths.placements),
                         device_mesh=mesh)(q, k, v, lengths)

    def merged(ql, kl, vl, ll):
        from repro_torch.kernels import ops
        if not whole:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        o, lse = ops.decode_attention_lse(
            ql, kl, vl, lengths=(ll - t0).to(torch.int32), window=window,
            softcap=softcap, scale=scale)
        # (B,H) lse, (B,1,H,hd) o: merged as a one-row attention
        return _merge(o, lse[..., None], seq_dims, mesh).to(ql.dtype)

    return local_map(merged, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements,
                                    v.placements, lengths.placements),
                     device_mesh=mesh)(q, k, v, lengths)


def mamba_chunk_scan(fn, x, dt, a, b, c, d, *, chunk, h0):
    op = "mamba_chunk_scan"
    mesh = next(t for t in (x, dt, a, b, c, d, h0)
                if isinstance(t, DTensor)).device_mesh
    x = _prepare(x, mesh)
    dt, a, b, c, d = (_prepare(t, mesh) for t in (dt, a, b, c, d))
    h0 = None if h0 is None else _prepare(h0, mesh)
    want = {"dt": [], "a": [], "bc": [], "h": []}
    grad_bc, grad_ad = [], []
    for p in x.placements:
        if p.is_replicate():
            want["dt"].append(p)
            want["a"].append(p)
            want["bc"].append(p)
            want["h"].append(p)
            grad_bc.append(p)
            grad_ad.append(p)
        elif p == Shard(0):
            want["dt"].append(Shard(0))
            want["a"].append(Replicate())
            want["bc"].append(Shard(0))
            want["h"].append(Shard(0))
            grad_bc.append(Shard(0))
            grad_ad.append(Partial())
        elif p == Shard(2):
            want["dt"].append(Shard(2))
            want["a"].append(Shard(0))
            want["bc"].append(Replicate())
            want["h"].append(Shard(1))
            grad_bc.append(Partial())
            grad_ad.append(Shard(0))
        else:
            _refuse(op, f"x placed {p}")

    def place(t, pl, name):
        for have, w in zip(t.placements, pl):
            if have != w and not have.is_replicate():
                _refuse(op, f"{name} placed {t.placements} against x's "
                            f"{x.placements}")
        return _to(t, pl)  # replicated -> sharded: a local slice

    dt = place(dt, want["dt"], "dt")
    a, d = place(a, want["a"], "a"), place(d, want["a"], "d")
    b, c = place(b, want["bc"], "B"), place(c, want["bc"], "C")
    args = [x, dt, a, b, c, d]
    pls = [x.placements, dt.placements, a.placements, b.placements,
           c.placements, d.placements]
    gpls = [x.placements, dt.placements, grad_ad, grad_bc, grad_bc,
            grad_ad]
    if h0 is not None:
        h0 = place(h0, want["h"], "h0")
        args.append(h0)
        pls.append(h0.placements)
        gpls.append(h0.placements)

    def local(*ts):
        return fn(*ts[:6], chunk=chunk, h0=ts[6] if len(ts) > 6 else None)

    return local_map(local, out_placements=(x.placements, tuple(want["h"])),
                     in_placements=tuple(pls),
                     in_grad_placements=tuple(tuple(g) for g in gpls),
                     device_mesh=mesh)(*args)
