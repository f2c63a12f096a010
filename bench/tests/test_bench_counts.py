"""``bench/counts`` pinned against figures worked out by hand from the
configurations' widths (granite-3-8b: 40 layers, d 4096, 32 q and 8 KV
heads of 128, d_ff 12800, vocab 49155; mamba2-1.3b: 48 layers, d 2048,
64 heads of 64, state 128, conv 4 over 4352 channels), and the kernel
counts charging only the layers that run the kernel."""

import dataclasses

import pytest

from bench import counts, model
from bench.tests.small import BENCH

GRANITE = model.load(BENCH / "configs" / "granite-3-8b.json")
MAMBA = model.load(BENCH / "configs" / "mamba2-1.3b.json")

# granite: per layer q,k,v,o 4096*128*(2*32 + 2*8) = 41,943,040, the MLP
# 3*4096*12800 = 157,286,400, two norms 8192; the tied table 49155*4096
GRANITE_PARAMS = 40 * (41943040 + 157286400 + 8192) + 201338880 + 4096
GRANITE_MATMUL = 40 * (41943040 + 157286400)
KV_TOKEN = 2 * 40 * 8 * 128 * 2                       # 163,840 B
LOGITS_ROW = 2 * 49155 * 4096


def test_parameter_counts():
    assert GRANITE.param_count == GRANITE_PARAMS == 8170848256
    assert GRANITE.matmul_param_count == GRANITE_MATMUL
    assert GRANITE.kv_bytes_per_token() == KV_TOKEN
    # mamba2: in_proj 2048*(2*4096 + 2*128 + 64), conv (4+1)*4352, A, dt
    # bias, D 3*64, gated norm 4096, out_proj 4096*2048, norm 2048
    layer = 2048 * 8512 + 5 * 4352 + 192 + 4096 + 4096 * 2048 + 2048
    assert MAMBA.param_count == 48 * layer + 50288 * 2048 + 2048


def test_granite_decode_round_at_64_rows():
    """64 rows at 1024 keys each: the weights (16.3 GB) and the K/V
    (10.7 GB) read once; memory bound, 8.09 ms."""
    flops, nbytes = counts.add(counts.step_weights(GRANITE, 1),
                               counts.decode_rows(GRANITE, [1024] * 64))
    row = 2 * GRANITE_MATMUL + LOGITS_ROW + 4 * 1024 * 32 * 128 * 40
    assert flops == 64 * row == 1088775782400
    assert nbytes == 2 * GRANITE_PARAMS + KV_TOKEN * (64 * 1024 + 64)
    t, bound = counts.least_seconds((flops, nbytes))
    assert bound == "bytes"
    assert t == pytest.approx(27089600512 / 3.35e12)


def test_paged_attention_call():
    """One round's paged attention over 40 layers: K/V of 64 x 1024 keys
    (8 heads of 128, bf16) and the 64 queries and outputs (32 heads);
    memory bound, 3.22 ms."""
    flops, nbytes = counts.paged_attention(GRANITE, [1024] * 64)
    assert flops == 4 * 65536 * 32 * 128 * 40 == 42949672960
    assert nbytes == 40 * (65536 * 8 * 128 * 4 + 64 * 32 * 128 * 4)
    t, bound = counts.least_seconds((flops, nbytes))
    assert bound == "bytes" and t == pytest.approx(10779361280 / 3.35e12)


def test_prefix_flash_chunk():
    """A 256-token chunk after 1024 committed tokens: 256*1024 + 256*257/2
    = 295,040 query-key pairs; compute bound, 0.196 ms."""
    flops, nbytes = counts.flash_prefix(GRANITE, 256, 1024)
    assert flops == 4 * 295040 * 32 * 128 * 40 == 193357414400
    assert nbytes == 40 * (2 * 256 * 32 * 128 * 2 + 1280 * 8 * 128 * 4)
    t, bound = counts.least_seconds((flops, nbytes))
    assert bound == "flops" and t == pytest.approx(193357414400 / 989e12)


def test_mamba2_state_scatter():
    """64 rows of state over 48 layers (conv window 3 x 4352 bf16, SSD
    64 x 64 x 128 float32: 2,123,264 B a layer), read and written:
    13.0 GB, memory bound, 3.89 ms."""
    assert MAMBA.state_bytes_per_row() == 48 * 2123264
    flops, nbytes = counts.state_scatter(MAMBA, 64)
    assert (flops, nbytes) == (0.0, 2 * 64 * 48 * 2123264)
    t, bound = counts.least_seconds((flops, nbytes))
    assert bound == "bytes" and t == pytest.approx(13045334016 / 3.35e12)


def test_whole_mixed_step():
    """One mixed round: the 64-row decode above, a 256-token chunk after
    1024 tokens, and the logits of the prompt it finishes: 5.36 TFLOP
    and 27.3 GB; memory bound, 8.15 ms."""
    flops, nbytes = counts.call(GRANITE, 1, [1024] * 64, [(256, 1024)], 1)
    chunk = 2 * GRANITE_MATMUL * 256 + 193357414400
    assert flops == 1088775782400 + chunk + LOGITS_ROW == 5362754805760
    assert nbytes == 27089600512 + KV_TOKEN * 1280
    t, bound = counts.least_seconds((flops, nbytes))
    assert bound == "bytes" and t == pytest.approx(27299315712 / 3.35e12)


def test_mamba2_decode_round_is_memory_bound():
    flops, nbytes = counts.call(MAMBA, 1, [1000] * 64, [], 0)
    ssm = 48 * (5 * 64 * 64 * 128 + 2 * 4 * 4352)
    row = 2 * MAMBA.matmul_param_count + 2 * 50288 * 2048 + ssm
    assert flops == 64 * row
    assert nbytes == 2 * MAMBA.param_count + 13045334016
    assert counts.least_seconds((flops, nbytes))[1] == "bytes"


def test_mamba2_ssd_step():
    """64 decode rows of the SSD state update over 48 layers: a row's
    float32 state (64 x 64 x 128, 2 MiB) read and written, x (4096 bf16,
    8 KiB), dt (64 float32), B and C (128 bf16 each) read and y (4096
    float32, 16 KiB) written: 4,219,648 B a layer, 13.0 GB in all;
    memory bound, 3.87 ms."""
    per_layer = 2 * 2097152 + 8192 + 256 + 512 + 16384
    assert per_layer == 4219648
    flops, nbytes = counts.ssd_step(MAMBA, 64)
    assert flops == 64 * 48 * 5 * 4096 * 128 == 8053063680
    assert nbytes == 64 * 48 * per_layer == 12962758656
    t, bound = counts.least_seconds((flops, nbytes))
    assert bound == "bytes" and t == pytest.approx(12962758656 / 3.35e12)


def test_kernel_counts_charge_only_the_layers_that_run_them():
    """Granite runs no SSD step and Mamba-2 no attention; a model with
    half its layers of each kind is charged half of each."""
    assert counts.ssd_step(GRANITE, 64) == (0.0, 0.0)
    assert counts.paged_attention(MAMBA, [1024] * 64) == (0.0, 0.0)
    half = dataclasses.replace(MAMBA, ssm_layers=24)
    assert counts.ssd_step(half, 64) == tuple(
        x / 2 for x in counts.ssd_step(MAMBA, 64))
    assert half.state_bytes_per_row() * 2 == MAMBA.state_bytes_per_row()
    half = dataclasses.replace(GRANITE, attn_layers=20)
    assert counts.paged_attention(half, [1024] * 64) == tuple(
        x / 2 for x in counts.paged_attention(GRANITE, [1024] * 64))
    assert half.kv_bytes_per_token() * 2 == GRANITE.kv_bytes_per_token()


@pytest.mark.parametrize("chips", [1, 2, 4])
def test_least_seconds_on_several_chips(chips):
    """``chips`` cards share the work evenly: the least time is one
    card's for ``1/chips`` of it, and at one card the same number as
    before the rank mode."""
    work = counts.call(GRANITE, 1, [1024] * 64, [(256, 1024)], 1)
    t, bound = counts.least_seconds(work, chips)
    assert bound == "bytes"
    assert t == pytest.approx(27299315712 / 3.35e12 / chips)
    if chips == 1:
        assert t == work[1] / counts.PEAK_BYTES_PER_S
