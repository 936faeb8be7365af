"""The dry run's per-device figures against JAX's compiled program on the
MoE, SSM, hybrid, encoder-decoder and VLM families (the dense cells are
``test_torch_dryrun_partitioned.py``'s).

One module-scoped fixture starts two JAX subprocesses (8 forced CPU
devices each; ``dryrun_parity.start_jax``) that compile eleven reduced cells at
batch 8 x 256 on a 2 x 4 ("data", "model") mesh with JAX's ``_lower_cell``,
and traces the same cells on a 2 x 4 meta mesh with the port's
``_trace_cell`` while JAX compiles (xlstm train in a subprocess of its own,
``dryrun_parity.start_port``, beside the others). Per cell:

* argument bytes equal ``argument_size_in_bytes`` to the byte (the serve
  step leaves out what JAX's ``jit`` prunes: the SSM's position, the
  hybrid cache's ``pos`` leaf, the encoder's parameters);
* FLOPs equal ``analyze_hlo``'s within 1e-6, but for five cells whose gap
  is the reference program's own, held to the exact difference (PERF.md
  §6): zamba2 train (JAX's ``lax.scan`` backward runs the state's products
  at the first and last chunk too, which eager autograd skips: 3 of
  524,288 FLOPs a layer, 4 layers, over 8 devices), xlstm prefill (JAX
  takes the normaliser's in-chunk sum as an einsum with a ones vector:
  2,048 FLOPs a chunk, 16 chunks, 2 layers), olmoe and whisper decode
  (XLA all-gathers the current key's head dim for the (4,)-block score
  where the port sums the split contraction: 128 FLOPs a layer), xlstm
  train (+237,568 a device: XLA fuses the four gate weights' gradients,
  (1024,) x (1024, 128) dots of 262,144 FLOPs, into fusions whose bodies
  ``analyze_hlo`` does not walk; its scans run products eager autograd
  skips: at the first and last chunk of each mLSTM layer three of 131,072
  and one of 4,096 FLOPs, and in each sLSTM layer the state's gradient
  into the zero state at step 0, 8,192);
* on train and prefill cells the temp bytes lie within 0.5-2x of
  ``temp_size_in_bytes`` (a decode cell's temp is XLA's f32 copies of the
  weights, ROADMAP C.7);
* the wire bytes a device lie within 0.5-2x of JAX's;
* on the three MoE train cells, xlstm train and xlstm prefill, the
  all-gather bytes lie within 0.5-2x of JAX's (none where JAX has none).

Toys counted by hand: MoE routing's index ops on a 2 x 4 meta mesh (a row
gather and an ``index_put_`` into a fresh buffer along a data-split dim,
no collective until the buffer is read whole); an einsum whose merged
(b, h) batch keeps "data" on b and "model" on h, also when its operands
come as partial sums over "model"; and a one-layer ``moe_ffn_sharded`` on
a 1 x 1 mesh whose backward region counts twice the forward region's
matmul FLOPs (two VJP products each, no rerun of the forward), and whose
second backward through one output raises, its graphs spent; a gradient
that takes its forward tensor's placement (y = x @ w cut on "model", cast,
times a replicated v: y's gradient, a product of whole operands, is
counted at y's block), and the same program under
``torch.utils.checkpoint``, whose rerun forward hooks no tensor again.
"""
import numpy as np
import pytest
import torch

import dryrun_parity as parity
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.roofline import analyze_program, wire_bytes
from repro_torch.launch.sharding import DEFAULT_RULES, NamedSharding, P, make_resolver
from repro_torch.models.common import use_sharding_rules
from repro_torch.models.moe import moe_capacity, moe_ffn_sharded

SEQ, BATCH = 256, 8
SM = {"moe_shard_map": True}
# (arch, kind, variant), all at the reduced config
CELLS = [("olmoe-1b-7b", "train", {}), ("olmoe-1b-7b", "train", SM),
         ("granite-moe-1b-a400m", "train", {}), ("zamba2-2.7b", "train", {}),
         ("zamba2-2.7b", "decode", {}), ("xlstm-1.3b", "prefill", {}),
         ("xlstm-1.3b", "decode", {}), ("olmoe-1b-7b", "decode", {}),
         ("whisper-tiny", "decode", {}), ("llama-3.2-vision-11b", "train", {}),
         ("xlstm-1.3b", "train", {})]
# port - JAX FLOPs a device where the gap is the reference program's own (docstring)
FLOP_GAP = {3: -3 * 524_288 * 4 // 8, 5: -2_048 * 16 * 2, 7: -128 * 2, 8: -128 * 2,
            10: 4 * 262_144 - 2 * (3 * 131_072 + 4_096) - 2 * 8_192}
ALLGATHER = {0, 1, 2, 5, 10}
# two JAX processes of about equal compile time (~20 s each on an 8-core host CPU)
GROUPS = ([0, 3, 10], [1, 2, 4, 5, 6, 7, 8, 9])
# traced by the port in a third process, beside the others (xlstm train: ~15 s)
BESIDE = [10]


@pytest.fixture(scope="module")
def cells():
    full = [(a, True, k, v) for a, k, v in CELLS]
    procs = [parity.start_jax([full[i] for i in g], seq=SEQ, batch=BATCH) for g in GROUPS]
    procs.append(parity.start_port([full[i] for i in BESIDE], seq=SEQ, batch=BATCH))
    try:
        port = {i: parity.port_cell(*c, seq=SEQ, batch=BATCH)
                for i, c in enumerate(full) if i not in BESIDE}
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.communicate()
        raise
    port.update(zip(BESIDE, parity.collect(procs.pop())))
    jax = {}
    for g, proc in zip(GROUPS, procs):
        jax.update(zip(g, parity.collect(proc)))
    return [(port[i], jax[i]) for i in range(len(full))]


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{k}{'-shard_map' if v else ''}" for a, k, v in CELLS])
def test_cell_per_device_against_jax_compiled(i, cells):
    kind = CELLS[i][1]
    port, jax = cells[i]
    c = parity.compare(port, jax)
    # nothing ran on a card: meta, and the host scalar of xlstm's 1/sqrt(dk)
    assert "meta" in port["devices"] and set(port["devices"]) <= {"meta", "cpu"}
    assert c["args_diff"] == 0
    if i in FLOP_GAP:
        assert c["flops_diff"] == FLOP_GAP[i]
    else:
        assert port["flops"] == pytest.approx(jax["flops"], rel=1e-6)
    if kind != "decode":
        assert 0.5 <= c["temp"] <= 2.0
    assert 0.5 <= c["wire"] <= 2.0
    if i in ALLGATHER:
        if jax["by_kind_bytes"].get("all-gather", 0.0):
            assert 0.5 <= c["allgather"] <= 2.0
        else:
            assert port["by_kind_bytes"].get("allgather", 0.0) == 0.0
    assert set(port["by_kind_bytes"]) <= set(parity.KINDS)


def _place(mesh, *pairs):
    return [(t, NamedSharding(mesh, P(*spec))) for t, spec in pairs]


def test_routing_index_ops_stay_local_along_the_data_split():
    mesh = parity.meta_mesh()
    table = torch.empty((16, 32), device="meta")  # replicated
    idx = torch.empty((8,), dtype=torch.int64, device="meta")  # split over "data"
    pl = _place(mesh, (table, ()), (idx, ("data",)))

    def gather():  # each device looks up its own 4 rows
        return table[idx]

    census = analyze_program(gather, mesh=mesh, shardings=pl)
    assert census.coll_by_kind_count == {} and census.wire_bytes == 0
    # reads the table whole and its 4 indices, writes its (4, 32) f32 block
    assert census.hbm_bytes == 16 * 32 * 4 + 4 * 8 + 4 * 32 * 4

    rows = torch.empty((8, 32), device="meta")  # split over "data", as the index
    pl = _place(mesh, (rows, ("data",)), (idx, ("data",)))

    def scatter(read):
        buf = rows.new_zeros((16, 32))
        buf[idx] = rows  # each device writes its own rows: a partial sum over "data"
        return torch.relu(buf) if read else buf

    census = analyze_program(lambda: scatter(False), mesh=mesh, shardings=pl)
    assert census.coll_by_kind_count == {} and census.wire_bytes == 0
    census = analyze_program(lambda: scatter(True), mesh=mesh, shardings=pl)
    # read whole, the buffer is summed over "data" once: its (16, 32) f32 block
    assert census.coll_by_kind_count == {"allreduce": 1}
    assert census.wire_bytes == wire_bytes("allreduce", 16 * 32 * 4, 2)


def test_einsum_merged_batch_keeps_data_on_b_and_model_on_h():
    mesh = parity.meta_mesh()
    b, l, h, k = 8, 32, 4, 16
    q = torch.empty((b, l, h, k), device="meta")
    kk = torch.empty((b, l, h, k), device="meta")
    block = 2 * (b // 2) * (h // 4) * l * l * k  # the (b/2, h/4) block's product
    pl = _place(mesh, (q, ("data", None, "model")), (kk, ("data", None, "model")))
    census = analyze_program(lambda: torch.einsum("blhk,bmhk->blmh", q, kk), mesh=mesh,
                             shardings=pl)
    assert census.flops == block and census.coll_by_kind_count == {}

    # q, k as partial sums over "model" (a projection whose contraction is
    # split over "model", as the mLSTM's): all-reduced, whole on each device
    # of "model", which the merged batch then takes on h
    x = torch.empty((b, l, 64), device="meta")
    w = torch.empty((64, h * k), device="meta")
    pl = _place(mesh, (x, ("data", None, "model")), (w, ("model", None)))

    def heads():
        qp = (x @ w).reshape(b, l, h, k)
        kp = (x @ w).reshape(b, l, h, k)
        return torch.einsum("blhk,bmhk->blmh", qp, kp)

    census = analyze_program(heads, mesh=mesh, shardings=pl)
    proj = 2 * (b // 2) * l * (64 // 4) * h * k  # each projection at its (b/2, 64/4) block
    assert census.flops == 2 * proj + block
    assert census.coll_by_kind_count == {"allreduce": 2}  # q and k, once each
    assert census.wire_bytes == 2 * wire_bytes("allreduce", (b // 2) * l * h * k * 4, 4)


def test_sharded_moe_backward_runs_no_forward_again():
    mesh = parity.meta_mesh((1, 1))
    B, T, d, f, E, top_k = 2, 16, 32, 48, 8, 2
    meta = dict(device="meta", requires_grad=True)
    p = {"router": torch.empty((d, E), **meta), "w_gate": torch.empty((E, d, f), **meta),
         "w_up": torch.empty((E, d, f), **meta), "w_down": torch.empty((E, f, d), **meta)}
    x3 = torch.empty((B, T, d), **meta)
    out = {}

    def forward():
        out["y"], out["aux"] = moe_ffn_sharded(p, x3, top_k)

    with use_sharding_rules(make_resolver(mesh, DEFAULT_RULES()), mesh):
        fwd = analyze_program(forward, mesh=mesh)
        leaves = [x3, *p.values()]
        dy, daux = torch.empty((B, T, d), device="meta"), torch.empty((), device="meta")
        bwd = analyze_program(lambda: torch.autograd.grad((out["y"], out["aux"]), leaves,
                                                          (dy, daux)), mesh=mesh)
    C = moe_capacity(B * T, top_k, E, 1.25)
    # the router's (T, d) x (d, E) and the experts' three (E, C, .) products
    assert fwd.flops == 2 * B * T * d * E + 3 * 2 * E * C * d * f
    assert bwd.flops == 2 * fwd.flops  # each product's two VJP products, nothing else
    assert fwd.region_counts == {"allreduce": 2, "allreduce.model": 1, "allreduce.aux": 1}
    assert bwd.region_counts == {"allreduce": 5, "allreduce.grad_x": 1,
                                 "allreduce.grad_router": 1, "allreduce.grad_experts": 3}


def test_sharded_moe_second_backward_raises():
    mesh = Mesh(np.array(["cpu"], dtype=object).reshape(1, 1), ("data", "model"))
    B, T, d, f, E = 2, 8, 16, 24, 4
    g = torch.Generator().manual_seed(0)
    p = {"router": torch.randn((d, E), generator=g), "w_gate": torch.randn((E, d, f), generator=g),
         "w_up": torch.randn((E, d, f), generator=g), "w_down": torch.randn((E, f, d), generator=g)}
    p = {k: v.requires_grad_() for k, v in p.items()}
    x3 = torch.randn((B, T, d), generator=g)
    with use_sharding_rules(make_resolver(mesh, DEFAULT_RULES()), mesh):
        y, aux = moe_ffn_sharded(p, x3, 2)
    loss = y.square().mean() + aux
    torch.autograd.grad(loss, list(p.values()), retain_graph=True)
    with pytest.raises(RuntimeError, match="one backward"):
        torch.autograd.grad(loss, list(p.values()))


def _projections(remat):
    """y = x @ w with w cut on "model" on its output dim, cast to bf16 (a
    rule that drops the matmul's record: the gradient's cast back to f32
    reads the product whole), z = y @ v with v replicated, a sum loss;
    then one op that reads x's gradient whole. On a 2 x 4 meta mesh, x
    replicated; ``remat`` runs the forward under torch.utils.checkpoint."""
    mesh = parity.meta_mesh()
    B, K, N, M = 16, 32, 64, 8
    x = torch.empty((B, K), device="meta", requires_grad=True)
    w = torch.empty((K, N), device="meta", requires_grad=True)
    v = torch.empty((N, M), device="meta", dtype=torch.bfloat16, requires_grad=True)
    pl = _place(mesh, (x, ()), (w, (None, "model")), (v, ()))

    def forward(x):
        return (x @ w).to(torch.bfloat16) @ v

    def step():
        z = checkpoint(forward, x, use_reentrant=False) if remat else forward(x)
        gx, _, _ = torch.autograd.grad(z.float().sum(), [x, w, v])
        gx.abs().sum()

    return analyze_program(step, mesh=mesh, shardings=pl), (B, K, N, M)


def test_gradient_takes_its_forward_tensors_placement():
    census, (B, K, N, M) = _projections(remat=False)
    # at one device's block, a quarter of each global product: x @ w (its
    # N cut), y @ v (a partial sum over "model"), dy = dz @ v^T (at y's
    # block: y's gradient takes y's placement; counted whole, 4x, before
    # the gradients of intermediates had placements), dv = y^T dz,
    # dx = dy @ w^T and dw = x^T dy
    assert census.flops == (2 * B * K * N + 2 * B * N * M + 2 * B * M * N + 2 * N * B * M
                            + 2 * B * N * K + 2 * K * B * N) // 4
    assert census.grad_hooks == 2  # x @ w and y: cut on "model"; z is replicated
    # dx, a partial sum over "model", is all-reduced where abs reads it
    # whole (the one all-reduce); v's gradient, cut on "model" like y, is
    # all-gathered to v's replicated placement (the one all-gather)
    assert census.coll_by_kind_count == {"allreduce": 1, "allgather": 1}
    assert census.coll_by_kind_bytes == {"allreduce": wire_bytes("allreduce", B * K * 4, 4),
                                         "allgather": wire_bytes("allgather", N * M * 2, 4)}


def test_remat_hooks_each_forward_tensor_once():
    plain, (B, K, N, M) = _projections(remat=False)
    remat, _ = _projections(remat=True)
    # the recompute in the backward adds x @ w at a quarter (it stops once
    # y, which the backward saved, is rebuilt) and no hook; the gradients
    # keep their cut
    assert remat.grad_hooks == plain.grad_hooks == 2
    assert remat.flops == plain.flops + 2 * B * K * N // 4
    assert remat.coll_by_kind_bytes == plain.coll_by_kind_bytes
