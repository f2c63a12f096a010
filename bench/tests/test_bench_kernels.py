"""Kernel names map to groups by data: every kernel in a listing the
card's profiler recorded (``kernel_names.txt``, from traced runs of the
cells on an H100) falls in a group."""

from pathlib import Path

import pytest

from bench import trace

LISTING = Path(__file__).resolve().parent / "kernel_names.txt"


def names():
    return [n for n in LISTING.read_text().splitlines() if n.strip()]


@pytest.mark.parametrize("name", names())
def test_every_recorded_kernel_has_a_group(name):
    assert trace.group_of(name, trace.load_groups()) != trace.UNMATCHED


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::paged_split_kernel<__nv_bfloat16, 128, 4>",
     "paged_attention"),
    ("void (anonymous namespace)::flash_tc_kernel<128>(...)",
     "flash_attention"),
    ("void (anonymous namespace)::state_scatter_kernel<...>",
     "state_scatter"),
    ("void (anonymous namespace)::page_rows_kernel<(anonymous namespace)::"
     "AndOp>(...)", "ambit"),
    ("void (anonymous namespace)::page_rows_cluster_kernel<(anonymous "
     "namespace)::CopyOp>(...)", "rowclone"),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_NNT", "matmul"),
    ("Memcpy HtoD (Pinned -> Device)", "memcpy"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("bench.engine_run", trace.UNMATCHED),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "nccl"),
])
def test_groups_by_pattern(name, group):
    assert trace.group_of(name, trace.load_groups()) == group


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert trace.union_seconds(iv) == 4
    assert trace.gaps(iv, 0, 8) == [(3, 5), (6, 8)]


def test_user_annotations_are_not_device_work():
    """The device timeline's user annotations (the harness's spans, and
    ``nccl:all_reduce`` spanning each NCCL kernel on the card) are left
    out of the device events, so a collective's time counts once."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, dev, s, e, note=False):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=s, end=e),
                               is_user_annotation=note)

    nccl = "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(x)"
    prof = SimpleNamespace(events=lambda: [
        ev("bench.slice", DeviceType.CPU, 0.0, 100.0),
        ev("bench.slice", DeviceType.CUDA, 0.0, 100.0, True),
        ev("nccl:all_reduce", DeviceType.CUDA, 10.0, 30.0, True),
        ev(nccl, DeviceType.CUDA, 10.0, 30.0),
        ev("nvjet_tst_128x64", DeviceType.CUDA, 40.0, 50.0)])
    sl = trace.Slice.from_profiler(prof)
    assert [d[0] for d in sl.device] == [nccl, "nvjet_tst_128x64"]
    assert sl.group_seconds() == {"nccl": 20e-6, "matmul": 10e-6}
    assert sl.busy_s == 30e-6 and sl.window_s == 100e-6
