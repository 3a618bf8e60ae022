"""Blockwise (fused) softmax cross-entropy over a large vocabulary (port of
``ray_tpu/ops/fused_ce.py``).

The loss ``logsumexp(x @ w [+ b]) - (x @ w [+ b])[target]`` per token,
computed without materializing more than one vocab chunk of logits:

* forward: one online-softmax pass over vocab chunks (running max, sum of
  exponentials, target-logit gather), keeping only ``(N,)`` statistics;
* backward: recompute each chunk's logits, form ``softmax - one-hot`` scaled
  by the cotangent, and accumulate ``dx``, ``dw`` (and ``db``) chunk by
  chunk.

The residuals are ``x`` and the ``(N,)`` logsumexp. The chunk products run
in the activation dtype with an fp32 result (the reference's
``preferred_element_type=float32``): on the card ``torch.mm`` with
``out_dtype``, on the CPU the exact fp32 products of the upcast operands.
The reference computes them in XLA, outside any Pallas kernel, so there is
no kernel here. Its sweep switches ``RAY_TPU_CE_CHUNKS`` and
``RAY_TPU_CE_SAVE_LOGITS`` are not ported (ROADMAP.md).

One shared implementation serves both entry points:
``fused_softmax_cross_entropy`` (GPT heads, no bias) and
``fused_softmax_cross_entropy_bias`` (GPT-J's biased untied head).
"""

from __future__ import annotations

import torch


def _pick_chunks(vocab: int, n_chunks: int | None) -> int:
    if n_chunks is not None:
        if vocab % n_chunks:
            raise ValueError(f"n_chunks={n_chunks} must divide vocab={vocab}")
        return n_chunks
    # Prefer the FINEST chunking whose chunks stay lane-ALIGNED (% 128) and
    # >= 4096 columns: a misaligned chunk width (e.g. 50304/32 = 1572) pads
    # on the MXU every step. Fall back to power-of-two chunking >= 1024
    # when the vocab's 128-quotient has no usable divisors.
    q, rem = divmod(vocab, 128)
    if rem == 0:
        best = 1
        for k in range(1, 65):
            if q % k == 0 and (vocab // k) % 128 == 0 and vocab // k >= 4096:
                best = k
        if best > 1 or vocab <= 8192:
            return best
    k = 1
    while k < 64 and vocab % (k * 2) == 0 and vocab // (k * 2) >= 1024:
        k *= 2
    return k


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, one dtype) with an fp32 result and fp32 accumulation."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # products of bf16 values are exact in fp32
    return a.float() @ b.float()


def _chunk_logits(x, w, b32, k: int, chunk: int) -> torch.Tensor:
    """fp32 logits of vocab chunk ``k`` (plus its bias slice), the product
    in ``x.dtype``."""
    sl = slice(k * chunk, (k + 1) * chunk)
    logits = _mm32(x, w[:, sl].to(x.dtype))
    if b32 is not None:
        logits = logits + b32[sl][None, :]
    return logits


def _ce_forward(x, w, b, targets, n_chunks: int):
    """Streaming forward; ``b`` may be None. Returns (losses, lse), fp32."""
    n = x.shape[0]
    chunk = w.shape[1] // n_chunks
    b32 = None if b is None else b.float()
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros(n, dtype=torch.float32, device=x.device)
    tl = torch.zeros(n, dtype=torch.float32, device=x.device)
    for k in range(n_chunks):
        logits = _chunk_logits(x, w, b32, k, chunk)  # (N, chunk) fp32
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
        # this chunk's target logits (0 for out-of-chunk targets)
        local = targets - k * chunk
        in_chunk = (local >= 0) & (local < chunk)
        picked = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        tl = tl + torch.where(in_chunk, picked, 0.0)
        m = m_new
    lse = m + torch.log(s)
    return lse - tl, lse


def _ce_backward(x, w, b, targets, lse, g, n_chunks: int):
    """(dx, dw, db-or-None) in the dtypes of x, w and b."""
    n, d = x.shape
    v = w.shape[1]
    chunk = v // n_chunks
    b32 = None if b is None else b.float()
    g = g.float()
    rows = torch.arange(n, device=x.device)
    dx = torch.zeros(n, d, dtype=torch.float32, device=x.device)
    dw = torch.empty(d, v, dtype=torch.float32, device=x.device)
    db = None if b is None else torch.empty(v, dtype=torch.float32, device=x.device)
    for k in range(n_chunks):
        sl = slice(k * chunk, (k + 1) * chunk)
        # recompute, then softmax - one-hot scaled by g, in place: the
        # (N, chunk) fp32 buffer is the step's largest transient
        dl32 = _chunk_logits(x, w, b32, k, chunk).sub_(lse[:, None]).exp_()
        local = targets - k * chunk
        in_chunk = (local >= 0) & (local < chunk)
        dl32[rows[in_chunk], local[in_chunk]] -= 1.0
        dl32.mul_(g[:, None])
        dlogits = dl32.to(x.dtype)
        dx += _mm32(dlogits, w[:, sl].to(x.dtype).t())
        dw[:, sl] = _mm32(x.t(), dlogits)
        if db is not None:
            db[sl] = dl32.sum(0)
    return dx.to(x.dtype), dw.to(w.dtype), None if b is None else db.to(b.dtype)


class _FusedCE(torch.autograd.Function):
    """Per-token loss without a bias."""

    @staticmethod
    def forward(ctx, x, w, targets, n_chunks):
        k = _pick_chunks(w.shape[1], n_chunks)
        losses, lse = _ce_forward(x, w, None, targets, k)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.n_chunks = k
        return losses

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw, _ = _ce_backward(x, w, None, targets, lse, g, ctx.n_chunks)
        return dx, dw, None, None


class _FusedCEBias(torch.autograd.Function):
    """Per-token loss with a differentiable (V,) logit bias."""

    @staticmethod
    def forward(ctx, x, w, b, targets, n_chunks):
        k = _pick_chunks(w.shape[1], n_chunks)
        losses, lse = _ce_forward(x, w, b, targets, k)
        ctx.save_for_backward(x, w, b, targets, lse)
        ctx.n_chunks = k
        return losses

    @staticmethod
    def backward(ctx, g):
        x, w, b, targets, lse = ctx.saved_tensors
        dx, dw, db = _ce_backward(x, w, b, targets, lse, g, ctx.n_chunks)
        return dx, dw, db, None, None


def fused_softmax_cross_entropy(x, w, targets, n_chunks=None):
    """Per-token cross-entropy ``logsumexp(x@w) - (x@w)[target]``.

    Args:
      x: ``(N, d)`` activations (bf16 recommended; products run in
        ``x.dtype`` with fp32 accumulation).
      w: ``(d, V)`` classifier weights (cast to ``x.dtype`` for the product).
      targets: ``(N,)`` integer class ids.
      n_chunks: vocab chunk count (must divide V); None = auto.

    Returns:
      ``(N,)`` fp32 per-token losses.
    """
    return _FusedCE.apply(x, w, targets.long(), n_chunks)


def fused_softmax_cross_entropy_bias(x, w, b, targets, n_chunks=None):
    """``fused_softmax_cross_entropy`` with a differentiable (V,) logit
    bias: loss = logsumexp(x@w + b) - (x@w + b)[t]."""
    return _FusedCEBias.apply(x, w, b, targets.long(), n_chunks)
