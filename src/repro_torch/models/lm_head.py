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

``vocab_xent`` is the same function on a rank's block of a table split
over the ``model`` mesh axis by vocab, as GSPMD partitions the
reference's custom VJP under the JAX rule set (its ``dW`` kept split
over ``vocab``): each chunk's log-sum-exp merges across ``model`` (the
max, then the sum of exponentials) and the gold logit comes from the
rank whose block holds it; the backward emits this rank's share of
``dx``, summed over ``model`` once, and keeps ``dW`` as the rank's
block.
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


class _VocabXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, table, labels, chunk, rules):
        mesh, v_l = rules.mesh, table.shape[0]
        lo = rules.index * v_l
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int32, device=x.device)
        lse = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
        for sl in _chunks(x.shape[1], chunk):
            logits = _logits(x[:, sl], table)
            l_c = labels[:, sl]
            mask = l_c != IGNORE
            local = torch.where(mask, l_c, 0).long() - lo
            own = (local >= 0) & (local < v_l)
            m = mesh.all_reduce(logits.amax(dim=-1), "model", op="max")
            gold = torch.gather(logits, -1,
                                local.clamp(0, v_l - 1)[..., None])[..., 0]
            # the sum of exponentials and the owner's gold logit, in one
            # sum over model
            both = mesh.all_reduce(torch.stack(
                [torch.exp(logits - m[..., None]).sum(dim=-1),
                 torch.where(own, gold, 0.0)]), "model")
            logz = m + torch.log(both[0])
            lse[:, sl] = logz
            nll = nll + torch.where(mask, logz - both[1], 0.0).sum()
            cnt = cnt + mask.sum().to(torch.int32)
        ctx.save_for_backward(x, table, labels, lse)
        ctx.chunk, ctx.rules = chunk, rules
        ctx.mark_non_differentiable(cnt)
        return nll, cnt

    @staticmethod
    def backward(ctx, dnll, _dcnt):
        x, table, labels, lse = ctx.saved_tensors
        rules, v_l = ctx.rules, table.shape[0]
        lo = rules.index * v_l
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        dW = torch.zeros(table.shape, dtype=torch.float32, device=x.device)
        for sl in _chunks(x.shape[1], ctx.chunk):
            x_c, l_c = x[:, sl], labels[:, sl]
            mask = l_c != IGNORE
            local = torch.where(mask, l_c, 0).long() - lo
            own = (local >= 0) & (local < v_l)
            # (softmax - one_hot) * mask * dnll over this rank's columns
            dlog = torch.exp(_logits(x_c, table) - lse[:, sl, None])
            dlog.scatter_add_(-1, local.clamp(0, v_l - 1)[..., None],
                              torch.where(own, -1.0, 0.0)[..., None])
            dlog.mul_((mask.float() * dnll)[..., None])
            dx[:, sl] = torch.einsum("bcv,vd->bcd", dlog, table.float())
            dW += torch.einsum("bcv,bcd->vd", dlog, x_c.float())
            del dlog
        dx = rules.mesh.all_reduce(dx, "model")
        return dx.to(x.dtype), dW.to(table.dtype), None, None, None


def vocab_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
               rules, chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_xent` with ``table`` this rank's block of vocab rows
    ``[index * V_l, (index + 1) * V_l)`` over ``rules``' ``model`` axis
    (a ``sharding.RuleLayout``) and ``x``, ``labels`` the same on every
    model rank: the same (nll_sum, count), differentiable in ``x`` (whole
    on every rank) and in ``table`` (this rank's block)."""
    return _VocabXent.apply(x, table, labels, chunk, rules)
