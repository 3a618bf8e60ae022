"""Ring attention: causal attention with the sequence axis sharded over the
``sp`` mesh axis, K/V chunks rotating around the ring (port of
``ray_tpu/ops/ring_attention.py``).

Each rank holds a contiguous ``seq / sp`` chunk of q, k and v, in sequence
order. It computes the online-softmax partials of its q chunk against the
k/v chunk it holds, then passes k/v on to the next rank of the ring
(``dist.batch_isend_irecv``; the backward sends the gradient the other way,
as ``ppermute`` transposes). After ``sp`` hops every query row has seen
every key it may attend: O(seq / sp) memory a rank.

The partials are fp32 products (``torch.einsum``), as the reference
computes them outside any kernel, merged with the flash kernels' algebra.
Each hop is checkpointed (``torch.utils.checkpoint``), so the backward
keeps a hop's inputs and not its (q, k) scores, as the reference's
``jax.checkpoint`` on the hop does. Every rank computes every hop, the
ones wholly in its queries' causal future too (they add zero weight), as
the reference does: every rotation's output then takes part in the loss
on every rank, so every rank's backward runs every reverse rotation, and
the ranks' graphs have one shape, so their backwards reach the rotations
and the parameters' reductions in one order.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.mesh import axis_size

NEG_INF = -1e30


def _chunk_partials(q_scaled, k, v, q_off: int, k_off: int):
    """Blockwise softmax partials of one q chunk against one k/v chunk.

    q_scaled (B, H, Sq, D) fp32, already scaled; returns (m (B, H, Sq),
    l (B, H, Sq), acc (B, H, Sq, D)), zero weight on causally masked
    keys."""
    sq, sk = q_scaled.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q_scaled, k.float())
    rows = q_off + torch.arange(sq, device=s.device)[:, None]
    cols = k_off + torch.arange(sk, device=s.device)[None, :]
    allowed = cols <= rows
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(allowed, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m, l, acc


def _hop(q32, m, l, acc, k, v, q_off: int, k_off: int):
    """One hop: the chunk's partials merged into the running (m, l, acc)."""
    cm, cl, cacc = _chunk_partials(q32, k, v, q_off, k_off)
    m_new = torch.maximum(m, cm)
    corr = torch.exp(m - m_new)
    ccorr = torch.exp(cm - m_new)
    l = l * corr + cl * ccorr
    acc = acc * corr[..., None] + cacc * ccorr[..., None]
    return m_new, l, acc


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent ``shift`` ranks on around ``group``'s ring; returns what
    the rank ``shift`` back sent."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """The ring's step (the reference's ``ppermute`` to the next rank); its
    backward sends the gradient to the previous rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _send_recv(grad, ctx.group, -1), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """Causal attention over ring-sharded sequences: q, k, v are this
    rank's (batch, heads, seq / sp, head_dim) chunks, the rank's position
    along ``mesh``'s ``axis`` giving the chunk's place in the sequence; the
    output is the rank's chunk in q's dtype. Every member of the axis calls
    it. With one rank on the axis there is one hop and no rotation."""
    from torch.utils.checkpoint import checkpoint

    sp = axis_size(mesh, axis)
    idx = mesh.get_local_rank(axis) if sp > 1 else 0
    b, h, s_local, d = q.shape
    q32 = q.float() * (1.0 / d**0.5)
    q_off = idx * s_local
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for r in range(sp):
        src = (idx - r) % sp  # the rank whose chunk this hop holds
        args = (q32, m, l, acc, kv[0], kv[1], q_off, src * s_local)
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(_hop, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            m, l, acc = _hop(*args)
        if r != sp - 1:
            kv = _Rotate.apply(kv, mesh.get_group(axis))
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh):
    """Ring attention on a mesh: batch over ``(dp, fsdp)``, heads over
    ``tp``, seq over ``sp``, head_dim whole, as the reference shard_maps
    ``ring_attention``. ``DTensor`` q, k, v (global (batch, heads, seq,
    head_dim)) are redistributed to that layout, their local chunks
    attended, and the result returned as a ``DTensor`` in it. Plain tensors
    are this rank's chunks already (the GPT block's, under ``models.gpt``'s
    ``mesh=``) and are attended as they are."""
    from ray_tpu_torch.parallel.sharding import is_dtensor, placements

    if not is_dtensor(q):
        return ring_attention(q, k, v, mesh)
    from torch.distributed.tensor import DTensor

    spec = placements((("dp", "fsdp"), "tp", "sp", None), mesh)
    q, k, v = (t.redistribute(mesh, spec) for t in (q, k, v))
    out = ring_attention(q.to_local(), k.to_local(), v.to_local(), mesh)
    return DTensor.from_local(out, mesh, spec, run_check=False, shape=q.shape, stride=q.stride())
