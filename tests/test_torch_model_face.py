"""The port's model face against the JAX package's, exactly.

The simulated DDR3 prototype (``core/{timing, isa, dram_model, memctrl,
subarray, coherence, poc, drange}.py``) is a numpy copy in the port, and
``DeviceLib`` sits on it in ``repro_torch.core.pimolib``.  On identical
inputs every number must equal the JAX package's bit for bit: the paper
speedups of ``EndToEndCosts`` and its batched costs, the subarray
discovery's groups and trial count, D-RaNGe characterization and the
TRNG's bits from one seed, and ``DeviceLib``'s copy, init, bitwise,
write and rand receipts.  The opcode-keyed registry is held to the
assertions of ``tests/test_pimolib.py`` (capability flags, queue kinds
from the registry, one-call registration), with the torch face in the
JAX face's place, and ``tests/test_system.py``'s workflow assertions
run on the port's copies.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (Blocking as JBlocking,  # noqa: E402
                        DRAMGeometry as JGeo, DRangeTRNG as JTRNG,
                        DeviceLib as JDeviceLib, EndToEndCosts as JCosts,
                        MemoryController as JMC, PimOpsController as JPOC,
                        SimulatedDRAM as JDRAM,
                        allocator_from_subarray_map as jalloc_from,
                        characterize as jcharacterize,
                        discover_subarrays as jdiscover)
from repro_torch.core import (Blocking, DRAMGeometry, DRangeTRNG,  # noqa: E402
                              DeviceLib, EndToEndCosts, Instruction,
                              MemoryController, Opcode, PimOpQueue,
                              PimOpsController, SimulatedDRAM, TorchLib,
                              allocator_from_subarray_map, characterize,
                              discover_subarrays, make_torch_arena)
from repro_torch.core import op_registry  # noqa: E402

PAPER = {"copy_no_coherence": 118.5, "init_no_coherence": 88.7,
         "copy_coherence": 14.6, "init_coherence": 12.6}


def _protos(**geo):
    """(port memory controller, JAX memory controller) of one geometry."""
    return (MemoryController(SimulatedDRAM(DRAMGeometry(**geo))),
            JMC(JDRAM(JGeo(**geo))))


def _device_libs(**geo):
    mc, jmc = _protos(**geo)
    smap, jsmap = discover_subarrays(mc), jdiscover(jmc)
    return (DeviceLib(PimOpsController(mc), allocator_from_subarray_map(smap)),
            JDeviceLib(JPOC(jmc), jalloc_from(jsmap)))


def _receipt(r):
    return (r.ok, r.op, r.face, r.n_ops, r.latency_ns)


def test_end_to_end_costs_match_jax():
    mc, jmc = _protos(num_subarrays=8, rows_per_subarray=32)
    c, jc = EndToEndCosts(mc), JCosts(jmc)
    sp = c.speedups()
    assert sp == jc.speedups()
    for k, target in PAPER.items():
        assert abs(sp[k] - target) / target < 0.10, (k, sp[k])
    for n in (1, 4, 37):
        assert c.batched_speedups(n) == jc.batched_speedups(n)
        for f in ("rowclone_copy_batched_ns", "rowclone_init_batched_ns",
                  "ambit_bitwise_batched_ns", "zero_scan_batched_ns"):
            assert getattr(c, f)(n) == getattr(jc, f)(n), (f, n)
    for f in ("cpu_copy_ns", "cpu_init_ns", "cpu_bitwise_ns", "cpu_scan_ns",
              "drange_latency_ns", "drange_throughput_mbps"):
        assert getattr(c, f)() == getattr(jc, f)(), f
    assert mc.stats == jmc.stats and mc.now_ns == jmc.now_ns


@pytest.mark.parametrize("geo,max_rows", [
    (dict(num_subarrays=8, rows_per_subarray=32), 64),
    (dict(num_subarrays=4, rows_per_subarray=16, row_bytes=64), None),
])
def test_discover_subarrays_matches_jax(geo, max_rows):
    mc, jmc = _protos(**geo)
    smap = discover_subarrays(mc, max_rows=max_rows)
    jsmap = jdiscover(jmc, max_rows=max_rows)
    assert smap.members == jsmap.members
    assert smap.group_of == jsmap.group_of
    assert smap.trials == jsmap.trials
    for g, rows in smap.members.items():
        assert len({mc.device._true_subarray_of(r) for r in rows}) == 1
    assert mc.now_ns == jmc.now_ns


def test_drange_characterize_and_trng_bits_match_jax():
    from repro.kernels.drange.ops import entropy_seed_from_trng as jseed
    from repro_torch.kernels.drange.ops import entropy_seed_from_trng
    mc, jmc = _protos(num_subarrays=4, rows_per_subarray=16)
    cmap = characterize(mc, rows=list(range(16)), n_bits=1024, samples=40)
    jcmap = jcharacterize(jmc, rows=list(range(16)), n_bits=1024,
                          samples=40)
    assert cmap.cells == jcmap.cells and cmap.total_cells > 0
    trng, jtrng = DRangeTRNG(PimOpsController(mc), cmap), \
        JTRNG(JPOC(jmc), jcmap)
    bits = trng.random_bits(512)
    np.testing.assert_array_equal(bits, jtrng.random_bits(512))
    assert 0.30 < bits.mean() < 0.70
    np.testing.assert_array_equal(trng.random_u32(3), jtrng.random_u32(3))
    assert entropy_seed_from_trng(trng, stream=5) == tuple(
        int(w) for w in np.asarray(jseed(jtrng, stream=5)))
    assert trng.stats == jtrng.stats


def test_device_lib_receipts_match_jax():
    lib, jlib = _device_libs(num_subarrays=2, rows_per_subarray=8,
                             row_bytes=64)
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, (2, 64)).astype(np.uint8)
    recs = []
    for L, B in ((lib, Blocking), (jlib, JBlocking)):
        src, dst = L.allocator.alloc_copy_pair(2)
        out = [L.write(src, payload),
               L.copy(src, dst, blocking=B.FIN),
               L.copy(src, dst, batch=False),
               L.bitwise("and", src, dst), L.bitwise("or", src, dst),
               L.bitwise("not", src, dst, blocking=B.FIN),
               L.cpu_copy(src, dst), L.cpu_bitwise("or", src, dst),
               L.init(src, 0.0, blocking=B.FIN), L.init(dst, 7),
               L.cpu_init(dst, 3), L.flush()]
        contents = (L.read(src), L.read(dst))
        recs.append(([_receipt(r) for r in out], contents, dict(L.stats),
                     L.poc.mc.now_ns))
    (r, c, s, t), (jr, jc, js, jt) = recs
    assert r == jr and s == js and t == jt
    for a, b in zip(c, jc):
        np.testing.assert_array_equal(a, b)
    # D-RaNGe through the lib: the same bits and latency
    for L in (lib, jlib):
        cmap = (characterize if L is lib else jcharacterize)(
            L.poc.mc, rows=list(range(16)), n_bits=512, samples=30)
        L.attach_trng((DRangeTRNG if L is lib else JTRNG)(
            L.poc, cmap, bits_per_read=1))
    bits, rec = lib.rand(100)
    jbits, jrec = jlib.rand(100)
    np.testing.assert_array_equal(bits, jbits)
    assert _receipt(rec) == _receipt(jrec)


def test_device_lib_refuses_what_the_model_face_cannot_do():
    lib, _ = _device_libs(num_subarrays=2, rows_per_subarray=8, row_bytes=64)
    with pytest.raises(NotImplementedError):
        lib.rand(8)                        # no TRNG attached
    src, dst = lib.allocator.alloc_copy_pair(1)
    with pytest.raises(ValueError):
        lib.init(dst, 0.5)                 # not a byte fill
    with pytest.raises(ValueError):
        lib.write(src, np.full((1, 64), 300.0))   # no truncation
    with pytest.raises(TypeError):
        lib.init(dst, Blocking.FIN)        # the v1 positional signature
    with pytest.raises(NotImplementedError):
        lib._run_op(Opcode.KV_WRITE, None, dst, Blocking.ACK, True,
                    write_back=False, coherence_on=dst)


def test_registry_capabilities_and_round_trip():
    lib, _ = _device_libs(num_subarrays=2, rows_per_subarray=8, row_bytes=64)
    tlib = TorchLib(make_torch_arena(2, 8, 64, dtype=torch.float32,
                                     device="cpu"))
    assert lib.supports(Opcode.RC_COPY) and tlib.supports(Opcode.RC_COPY)
    assert lib.supports(Opcode.RC_INIT) and tlib.supports(Opcode.RC_INIT)
    assert not lib.supports(Opcode.KV_WRITE) and tlib.supports(Opcode.KV_WRITE)
    assert tlib.supports(Opcode.DR_GEN) and not lib.supports(Opcode.DR_GEN)
    # every torch-face kind reaches a new queue, in the JAX order
    from repro.core import op_registry as jreg
    kinds = [s.torch_kind for s in
             op_registry.ops_for_face(op_registry.FACE_TORCH)
             if s.torch_kind is not None]
    assert kinds == [s.jax_kind for s in jreg.ops_for_face(jreg.FACE_JAX)
                     if s.jax_kind is not None]
    q = PimOpQueue()
    assert all(q.has_kind(k) for k in kinds)
    # one call registers a new op; queues built afterwards see it
    opcode = Opcode.NOP
    assert op_registry.get_op(opcode) is None

    def _flush_touch(q, arenas, ops):
        q._count_launch("touch", len(arenas))
        return arenas

    spec = op_registry.PimOpSpec(opcode=opcode, name="touch",
                                 torch_kind="touch", torch_flush=_flush_touch)
    op_registry.register_pim_op(spec)
    try:
        with pytest.raises(ValueError):
            op_registry.register_pim_op(spec)     # no silent override
        with pytest.raises(ValueError):
            op_registry.register_pim_op(op_registry.PimOpSpec(
                opcode=opcode, name="half", torch_kind="x"), override=True)
        q = PimOpQueue()
        q.enqueue("touch", ("x",))
        q.enqueue("touch", ("y",))
        q.flush(torch.zeros((1, 2, 2)))
        assert q.launches_by_kind["touch"] == 1
        assert q.stats["ops_enqueued"] == 2
        assert tlib.supports(opcode) and not lib.supports(opcode)
    finally:
        assert op_registry.unregister_pim_op(opcode) is spec
    assert op_registry.get_op(opcode) is None
    assert not PimOpQueue().has_kind("touch")


def test_system_workflow_on_the_ports_copies():
    """``tests/test_system.py``'s workflow and protocol assertions."""
    mc, _ = _protos(num_subarrays=4, rows_per_subarray=16)
    dev = mc.device
    res = mc.run_sequence("rowclone_copy", 0, 0)
    gaps = [cmd.at_ns for cmd in res.commands]
    assert gaps[1] - gaps[0] < mc.t.tRAS / 4
    assert gaps[2] - gaps[1] < mc.t.tRP / 4
    alloc = allocator_from_subarray_map(discover_subarrays(mc, max_rows=32))
    lib = DeviceLib(PimOpsController(mc), alloc)
    src, dst = alloc.alloc_copy_pair(2)
    pat = np.random.default_rng(1).integers(0, 256, dev.geometry.row_bytes,
                                            dtype=np.uint8)
    dev.write_row(src.rows[0], pat)
    assert lib.copy(src, dst, blocking=Blocking.FIN).ok
    assert (dev.read_row(dst.rows[0]) == pat).all()
    rec = lib.init(dst)
    assert rec.ok and (dev.read_row(dst.rows[0]) == 0).all()
    assert lib.cpu_copy(src, dst).latency_ns > 50 * rec.latency_ns
    clean = lib.copy(src, dst).latency_ns
    alloc.touch_cpu_write(src)
    assert lib.copy(src, dst).latency_ns > clean + 1000   # CLFLUSH cost
    insn = Instruction(Opcode.RC_COPY, 123, 456)
    assert Instruction.decode(insn.encode()) == insn
    poc = PimOpsController(mc)
    poc.store_instruction(Instruction(Opcode.RC_COPY, 0, 0).encode())
    poc.store_start()
    flags = poc.load_flags()
    assert flags.ack and flags.fin and not flags.start


def test_cross_face_parity_torch_and_device():
    """The same protocol trace through DeviceLib and TorchLib: the same
    page contents, and receipts that agree on op and n_ops, each face
    filling its own accounting column."""
    lib, _ = _device_libs(num_subarrays=2, rows_per_subarray=8, row_bytes=64)
    tlib = TorchLib(make_torch_arena(2, 8, 64, dtype=torch.float32,
                                     device="cpu"))
    payload = np.random.default_rng(3).integers(0, 256, (2, 64)) \
        .astype(np.uint8)
    out = []
    for L, vals in ((lib, payload),
                    (tlib, torch.from_numpy(payload.astype(np.float32)))):
        src, dst = L.allocator.alloc_copy_pair(2)
        recs = [L.write(src, vals), L.copy(src, dst, blocking=Blocking.FIN),
                L.init(src, 0.0, blocking=Blocking.FIN),
                L.flush(Blocking.FIN)]
        out.append((np.asarray(L.read(dst), np.float32),
                    np.asarray(L.read(src), np.float32), recs))
    (d_dst, d_src, d_recs), (t_dst, t_src, t_recs) = out
    np.testing.assert_array_equal(d_dst, t_dst)
    assert not d_src.any() and not t_src.any()
    for d, t in zip(d_recs, t_recs):
        assert d.ok and t.ok and d.n_ops == t.n_ops
        assert d.face == "device" and t.face == "torch"
    assert d_recs[1].op == t_recs[1].op == "rowclone_copy"
    assert d_recs[2].op == t_recs[2].op == "rowclone_init"
    assert d_recs[1].latency_ns > 0 and d_recs[1].launches == 0
    assert t_recs[1].launches >= 1 and t_recs[1].latency_ns == 0.0


def test_quickstart_matches_the_jax_quickstart(capsys):
    """The quickstart's port on the CPU: its model-face numbers are the
    JAX quickstart's (same prototype, same discovery), the torch face's
    copy lands, and its 2-layer trace replays to the JAX totals."""
    import importlib.util
    import pathlib
    from repro_torch.examples import quickstart
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / "quickstart.py"
    spec = importlib.util.spec_from_file_location("jax_quickstart", path)
    jq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jq)
    got = quickstart.main(["--device", "cpu"])
    assert got["torch_copy_matches"]
    mc, jmc = _protos(num_subarrays=8, rows_per_subarray=32)
    assert got["speedups"] == JCosts(jmc).speedups()
    jsmap = jdiscover(jmc, max_rows=64)
    assert (got["groups"], got["trials"]) == (jsmap.num_groups, jsmap.trials)
    jq.main()
    out = capsys.readouterr().out
    rep = got["replay"]
    assert f"pim total:  {rep['pim_ns']['total']:.0f} ns" in out
    assert f"cpu total:  {rep['cpu_ns']['total']:.0f} ns" in out


def test_drange_entropy_example_matches_jax(capsys):
    """The entropy-source example's port: the same TRNG bits and kernel
    seed as the JAX example's pipeline, and the block generator's
    uniforms from that seed bit for bit (the generator's plain version
    on the CPU)."""
    from repro.core.drange import DRangeTRNG as JT
    from repro.kernels.drange import ops as jdr
    from repro_torch.examples import drange_entropy
    got = drange_entropy.main(["--device", "cpu"])
    jmc = JMC(JDRAM(JGeo(num_subarrays=8, rows_per_subarray=32)))
    jcmap = jcharacterize(jmc, rows=list(range(32)), n_bits=1024,
                          samples=100)
    jtrng = JT(JPOC(jmc), jcmap)
    np.testing.assert_array_equal(got["bits"], jtrng.random_bits(4096))
    jseed = jdr.entropy_seed_from_trng(jtrng)
    assert got["seed"] == tuple(int(w) for w in np.asarray(jseed))
    np.testing.assert_array_equal(
        got["block"].numpy(), np.asarray(jdr.pim_random_uniform(jseed, 4, 8)))
