"""Memory-efficient LM head: chunked fused softmax cross-entropy.

The port's counterpart of the JAX package's ``models/lm_head.py``.  The
float32 logits of a 256 000-token vocab over a batch of 4 x 2048 tokens
take 8.4 GB, and autograd would hold them beside their softmax and
their gradient.  ``fused_xent`` (a ``torch.autograd.Function``, the
reference's custom VJP) walks the sequence in chunks instead: the
forward keeps no logits, and the backward recomputes each chunk's,
emits that chunk's ``dx`` and accumulates ``dW`` in float32, so the
extra memory is one chunk's.

The logits are float32 products of float32 operands, as in the
reference; they run at full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default).

Semantics: the sum of per-token NLL over the labels that are not
``IGNORE``, and their count, so the caller chooses the mean.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

IGNORE = -100


def _chunks(s: int, chunk: int) -> Iterator[slice]:
    """The reference's chunking: ``nc = max(s // chunk, 1)`` chunks of
    ``s // nc``, then the remainder as one more."""
    nc = max(s // chunk, 1)
    cs = s // nc
    for c in range(nc):
        yield slice(c * cs, (c + 1) * cs)
    if nc * cs < s:
        yield slice(nc * cs, s)


def _logits(x_c: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bcd,vd->bcv", x_c.float(), table.float())


class _FusedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, table, labels, chunk):
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int32, device=x.device)
        for sl in _chunks(x.shape[1], chunk):
            logits = _logits(x[:, sl], table)
            l_c = labels[:, sl]
            mask = l_c != IGNORE
            safe = torch.where(mask, l_c, 0).long()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, safe[..., None])[..., 0]
            nll = nll + torch.where(mask, logz - gold, 0.0).sum()
            cnt = cnt + mask.sum().to(torch.int32)
        ctx.save_for_backward(x, table, labels)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(cnt)
        return nll, cnt

    @staticmethod
    def backward(ctx, dnll, _dcnt):
        x, table, labels = ctx.saved_tensors
        dx = torch.empty_like(x)
        dW = torch.zeros(table.shape, dtype=torch.float32, device=x.device)
        for sl in _chunks(x.shape[1], ctx.chunk):
            x_c, l_c = x[:, sl], labels[:, sl]
            mask = l_c != IGNORE
            safe = torch.where(mask, l_c, 0).long()
            # (softmax - one_hot) * mask * dnll, formed in the softmax's
            # buffer: subtracting 1 at the gold index is the one-hot's
            # subtraction, value for value
            dlog = torch.softmax(_logits(x_c, table), dim=-1)
            dlog.scatter_add_(-1, safe[..., None],
                              torch.full_like(dlog[..., :1], -1.0))
            dlog.mul_((mask.float() * dnll)[..., None])
            dx[:, sl] = torch.einsum("bcv,vd->bcd", dlog,
                                     table.float()).to(x.dtype)
            dW += torch.einsum("bcv,bcd->vd", dlog, x_c.float())
            del dlog
        return dx, dW.to(table.dtype), None, None


def fused_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d); table: (V, d); labels: (b, s) -> (nll_sum float32,
    count int32), both 0-d.  Differentiable in ``x`` and ``table``."""
    return _FusedXent.apply(x, table, labels, chunk)
