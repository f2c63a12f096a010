"""The system under test: ``repro_torch``'s paged engine and its async
front door, built from a configuration file and the benchmark's
weights.  The only module of the benchmark that imports the program.

It uses the program's public surface: ``ModelConfig``/``SSMConfig``,
``transformer.model_defs`` (to check the weights' layout),
``PagedEngine`` (``submit``, ``run``, ``has_work``,
``prefill_backlog_tokens``, ``stats``, ``cache``), ``Request``,
``AsyncServer``/``TokenStream`` and ``kernels.LAUNCHES``.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench.model import Model


def program_config(m: Model):
    """The program's ``ModelConfig`` for ``m``."""
    from repro_torch.configs.base import ModelConfig, SSMConfig

    if m.family == "dense":
        return ModelConfig(
            name=m.name, family="dense", num_layers=m.layers,
            d_model=m.d_model, num_heads=m.heads, num_kv_heads=m.kv_heads,
            head_dim=m.head_dim, d_ff=m.d_ff, vocab_size=m.vocab,
            activation="swiglu", norm_eps=m.norm_eps,
            rope_theta=m.rope_theta, tie_embeddings=True)
    s = m.ssm
    # an attention-free model has no KV heads; the engine still keeps a
    # full-depth KV arena for it, sized by these fields alone
    kv = m.raw["phantom_kv"]
    return ModelConfig(
        name=m.name, family="ssm", num_layers=m.layers, d_model=m.d_model,
        num_heads=kv["num_kv_heads"], num_kv_heads=kv["num_kv_heads"],
        head_dim=kv["head_dim"], d_ff=0, vocab_size=m.vocab, activation="swiglu",
        norm_eps=m.norm_eps, tie_embeddings=True,
        ssm=SSMConfig(state_dim=s.state, head_dim=s.head_dim,
                      expand=s.expand, conv_width=s.conv,
                      chunk_size=s.chunk),
        supports_long_context=True)


def program_params(m: Model, w: Dict[str, torch.Tensor], cfg) -> Dict:
    """The program's parameter tree over the benchmark's weights (views:
    the two sides read the same memory), checked leaf by leaf against
    the shapes the program defines."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves

    L, d = m.layers, m.d_model
    if m.family == "dense":
        H, kvh, hd = m.heads, m.kv_heads, m.head_dim
        group = {
            "0_attn": {"norm": w["attn_norm"], "attn": {
                "wq": w["wq"].view(L, d, H, hd),
                "wk": w["wk"].view(L, d, kvh, hd),
                "wv": w["wv"].view(L, d, kvh, hd),
                "wo": w["wo"].view(L, H, hd, d)}},
            "1_mlp": {"norm": w["mlp_norm"], "mlp": {
                "up": w["w_up"], "gate": w["w_gate"], "down": w["w_down"]}}}
    else:
        group = {"0_mamba": {"norm": w["norm"], "ssm": {
            k: w[k] for k in ("in_proj", "conv_w", "conv_b", "a_log",
                              "dt_bias", "d_skip", "out_norm", "out_proj")}}}
    params = {"embed": {"tok": w["embed"]}, "final_norm": w["final_norm"],
              "group0": group}
    want = {p: tuple(d_.shape) for p, d_ in tree_leaves(T.model_defs(cfg))}
    have = {p: tuple(t.shape) for p, t in tree_leaves(params)}
    if want != have:
        raise ValueError(f"weights do not fit the program's layout: "
                         f"{sorted(set(want.items()) ^ set(have.items()))}")
    return params


def engine(m: Model, w: Dict[str, torch.Tensor], seed: int, device,
           **override):
    """A ``PagedEngine`` for ``m`` with the configuration file's engine
    settings (``override`` replaces some, for the CPU tests)."""
    from repro_torch.serving.engine import PagedEngine

    cfg = program_config(m)
    kw = dict(m.engine, **override)
    zero_scan = kw.pop("zero_scan", False)
    eng = PagedEngine(cfg, program_params(m, w, cfg), seed=seed,
                      device=device, **kw)
    if zero_scan:
        eng.cache.enable_zero_scan()
    return eng


def request(rid: int, prompt, max_new: int, temperature: float):
    from repro_torch.serving.engine import Request

    return Request(rid, prompt, max_new_tokens=max_new,
                   temperature=temperature)


def server(m: Model, eng):
    """The async front door with no deadline (nothing is shed) and the
    configuration file's ``front_door`` settings."""
    from repro_torch.serving.server import AsyncServer

    return AsyncServer(eng, ttft_slo_ms=None, **m.raw.get("front_door", {}))


def launches() -> Dict[str, int]:
    from repro_torch.kernels import LAUNCHES

    return dict(LAUNCHES)


def arena_residue(eng) -> int:
    """Nonzero elements in the arena pages and state rows that nothing
    holds: a page or row is zeroed when it is freed (RowClone-Init, or
    skipped where the Ambit zero scan found it zero already), so a free
    one holds only zeros.  Live sequences and the prefix cache keep
    theirs."""
    cache = eng.cache
    cache.flush_pending()
    n_pages = cache.k_arena.shape[1]
    free = sorted(set(range(n_pages)) - set(cache.refcount))
    n = 0
    if free:
        idx = torch.as_tensor(free, device=cache.k_arena.device)
        # a layer at a time: a whole arena's comparison would not fit
        for a in (cache.k_arena, cache.v_arena):
            n += sum(int(torch.count_nonzero(a[i].index_select(0, idx)))
                     for i in range(a.shape[0]))
    st = cache.state
    if st is not None:
        rows = sorted(set(range(st.num_slots)) - set(st.rows.values()))
        if rows:
            idx = torch.as_tensor(rows, device=st.ssm.device)
            for a in (st.conv, st.ssm):
                n += sum(int(torch.count_nonzero(a[g, j].index_select(0, idx)))
                         for g in range(a.shape[0])
                         for j in range(a.shape[1]))
    return n
