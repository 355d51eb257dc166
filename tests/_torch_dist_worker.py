"""One rank of the two-rank gloo run of tests/test_torch_dist.py.

    python tests/_torch_dist_worker.py RANK WORLD DIR

Joins a gloo process group through a FileStore in DIR, reads the inputs
the test wrote (DIR/inputs.pt), runs every sharded case on (data, model)
meshes of the two ranks and writes what it computed to DIR/out_RANK.pt: a
dict of case name -> result, or the traceback of a case that raised.
Imports the port only (no jax, no reference module)."""
import dataclasses
import os
import sys
import traceback

import torch
import torch.distributed as dist


def _grad(out, wrt, cot):
    return torch.autograd.grad((out * cot).sum(), wrt)


def case_chain(inp, spec):
    """plan_chain with ragged rows: values and gradients (x, w), tree and
    the pinned kernel backend (its plain version on the CPU)."""
    from repro_torch.core import engine

    x0, w0, cot = inp["chain_x"], inp["chain_w"], inp["chain_cot"]
    res = {}
    for backend in (None, "fused_hopper"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        cp = engine.plan_chain((2, 2, 2), 2, backend=backend, shard_spec=spec, device="cpu")
        y = cp.apply([x, x, x], weights=[w, w, None])
        res[str(backend)] = (y.detach(), *_grad(y, [x, w], cot))
        res[f"{backend}_backend"] = cp.backend
        other = "shard_map" if spec.mode == "constraint" else "constraint"
        res[f"{backend}_one_plan_for_both_modes"] = cp is engine.plan_chain(
            (2, 2, 2), 2, backend=backend, device="cpu",
            shard_spec=engine.ShardSpec(spec.mesh, mode=other))
    return res


def case_batch(inp, spec):
    """plan_batch over two ragged items (5 and 3 rows): values and
    gradients; the pinned pair kernel bucket (plain on the CPU) values."""
    from repro_torch.core import engine

    res = {}
    items = [(2, 2, 4, 5), (1, 2, 3, 3)]
    ops = [(inp["b_a1"], inp["b_a2"]), (inp["b_b1"], inp["b_b2"])]
    leaves = [t.clone().requires_grad_(True) for pair in ops for t in pair]
    bp = engine.plan_batch(items, shard_spec=spec, device="cpu")
    out = bp.apply([(leaves[0], leaves[1]), (leaves[2], leaves[3])])
    loss = sum((o * c).sum() for o, c in zip(out, (inp["b_c1"], inp["b_c2"])))
    res["values"] = [o.detach() for o in out]
    res["grads"] = list(torch.autograd.grad(loss, leaves))
    res["granularity"] = bp.granularity
    kp = engine.plan_batch(items, backend="fused_hopper", requires_grad=False,
                           shard_spec=spec, device="cpu")
    with torch.no_grad():
        res["kernel"] = kp.apply(ops)
    return res


def case_conv(inp, spec):
    """EquivariantConv: eSCN on raw directions and on WignerBlocks, the
    general conv on a resident filter; values and the direction gradient."""
    from repro_torch.core.conv import EquivariantConv

    res = {}
    x, r0, w1, cot = inp["c_x"], inp["c_r"], inp["c_w1"], inp["c_cot"]
    for method in ("escn", "general"):
        conv = EquivariantConv(2, 2, 2, method=method, shard_spec=spec, device="cpu")
        r = r0.clone().requires_grad_(True)
        geom = conv.geometry_rep(r) if method == "escn" else conv.filter_rep(r)
        y = conv(x, geom, w1=w1)
        res[method] = (y.detach(), *_grad(y, [r], cot))
        y_raw = conv(x, r0, w1=w1)
        res[method + "_raw"] = y_raw.detach()
    return res


def case_manybody(inp, spec):
    """manybody_gaunt_product on the chain route and the packed batched
    route."""
    from repro_torch.core.manybody import manybody_gaunt_product

    xs = [inp["m_x1"], inp["m_x2"], inp["m_x3"]]
    return {"chain": manybody_gaunt_product(xs, [1, 2, 1], Lout=2, shard_spec=spec),
            "packed": manybody_gaunt_product(xs, [1, 2, 1], Lout=2, conversion="packed",
                                             shard_spec=spec)}


def case_selfmix(inp, spec):
    """SelfmixLayer on the resident chain and on the pairwise route, with
    the input gradient."""
    from repro_torch.models.equivariant import SelfmixLayer

    res = {}
    for impl in ("gaunt", "gaunt_fused"):
        layer = SelfmixLayer(2, 4, tp_impl=impl, shard_spec=spec, device="cpu")
        layer.load_state_dict(inp[f"s_state_{impl}"])
        x = inp["s_x"].clone().requires_grad_(True)
        y = layer(x)
        res[impl] = (y.detach(), *_grad(y, [x], inp["s_cot"]))
    return res


def case_mace(inp, mesh):
    """MaceGaunt with shard_data and the activation mesh registered: energy
    and forces of each molecule, the loss and every parameter's gradient
    through the double backward."""
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.models.equivariant import MaceGaunt

    cfg = dataclasses.replace(gaunt_mace_ff, **inp["mace_cfg"], shard_data=True)
    model = MaceGaunt(cfg, device="cpu")
    model.load_state_dict(inp["mace_state"])
    set_activation_mesh(mesh)
    try:
        e, f = model.energy_forces(inp["mace_species"], inp["mace_pos"])
        batch = {k: inp["mace_" + k] for k in ("species", "pos", "energy", "forces")}
        loss = model.loss(batch)
        names = [k for k, _ in model.named_parameters()]
        gs = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    finally:
        set_activation_mesh(None)
    return {"energy": e, "forces": f, "loss": loss.detach(),
            "grads": dict(zip(names, gs))}


def case_serve(inp, mesh):
    """A shard_data force field with chain_tune='measure' served on the
    activation mesh: warmup times no chain (sharded chains are 'tree'), and
    each served energy and force equals the unsharded model's direct one."""
    import numpy as np

    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.core import engine
    from repro_torch.distributed.sharding import set_activation_mesh
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.serve.engine import EquivariantRequest, EquivariantServeEngine

    cfg = dataclasses.replace(gaunt_mace_ff, **inp["mace_cfg"], chain_tune="measure")
    plain = MaceGaunt(cfg, device="cpu")
    plain.load_state_dict(inp["mace_state"])
    model = MaceGaunt(dataclasses.replace(cfg, shard_data=True), device="cpu")
    model.load_state_dict(inp["mace_state"])
    set_activation_mesh(mesh)
    try:
        engine.get_engine().clear()
        eng = EquivariantServeEngine(model, n_slots=2, max_atoms=6, warmup=True)
        runs = engine.get_engine().timing_runs
        rng = np.random.default_rng(4)
        reqs = [EquivariantRequest(rng.integers(0, 4, n),
                                   (rng.normal(size=(n, 3)) * 1.5).astype(np.float32), rid=i)
                for i, n in enumerate((3, 5, 6))]
        out = eng.run(reqs)
    finally:
        set_activation_mesh(None)
    served = [(torch.tensor(r.energy), torch.as_tensor(r.forces)) for r in out]
    direct = [plain.energy_forces(torch.as_tensor(r.species), torch.as_tensor(r.pos))
              for r in out]
    return {"timing_runs": runs, "served": served, "direct": direct,
            "done": [r.done and not r.rejected for r in out]}


def _tiny_lm(inp):
    from repro_torch.config import get_config
    from repro_torch.models.api import LMModule

    cfg = get_config("qwen2-0.5b").reduced(**inp["lm_over"])
    return cfg, LMModule(cfg, _clone_tree(inp["lm_params"]))


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_clone_tree(v) for v in t]
    return t.clone()


def _train(inp, mesh, steps, ckpt=None, tcfg_kw=None):
    from repro_torch.config import TrainConfig
    from repro_torch.data import LMTokenPipeline
    from repro_torch.train import train_loop

    cfg, module = _tiny_lm(inp)
    pipe = LMTokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    tcfg = TrainConfig(**dict(inp["lm_tcfg"], total_steps=steps, **(tcfg_kw or {})))
    state, hist = train_loop(lambda m, b: m.loss(b), module, pipe, tcfg, ckpt_dir=ckpt,
                             hooks={"preemption": False}, mesh=mesh)
    return {"loss": [h["loss"] for h in hist], "steps": [h["step"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "params": {k: p.detach().full_tensor() for k, p in module.named_parameters()},
            "mu_is_dtensor": type(state.opt_state["mu"][next(iter(state.opt_state["mu"]))])
            .__name__,
            "ef": None if state.ef is None else {k: v.to_local() for k, v in state.ef.items()}}


def case_train(inp, meshes):
    """Three steps of reduced qwen2-0.5b on a (2, 1) and on a (1, 2) mesh."""
    return {name: _train(inp, m, 3) for name, m in meshes.items()}


def case_elastic_resume(inp, meshes, d):
    """Two steps on (2, 1) with checkpoints, then resumed on (1, 2) to step
    three: the checkpoint written on one mesh restores onto the other."""
    ckpt = os.path.join(d, "ckpt_elastic")
    first = _train(inp, meshes["2x1"], 2, ckpt=ckpt, tcfg_kw={"checkpoint_every": 1})
    second = _train(inp, meshes["1x2"], 3, ckpt=ckpt)
    return {"first": first, "second": second}


def case_int8(inp, rank):
    """int8_ef_cross_pod_mean at pod=2 (this rank's gradient is its own)
    and at pod=1 (a (1, 2, 1) mesh: each rank alone in its pod)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.collectives import ef_state_init, int8_ef_cross_pod_mean

    g = {"a": inp["q_g"][rank], "b": inp["q_h"][rank]}
    e = {"a": inp["q_e"][rank], "b": torch.zeros_like(inp["q_h"][rank])}
    res = {}
    pod2 = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names=("pod", "data", "model"))
    res["pod2"] = int8_ef_cross_pod_mean(g, e, pod2)
    pod1 = init_device_mesh("cpu", (1, 2, 1), mesh_dim_names=("pod", "data", "model"))
    res["pod1"] = int8_ef_cross_pod_mean(g, ef_state_init(g), pod1)
    flat = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    res["no_pod"] = int8_ef_cross_pod_mean(g, e, flat)
    # the train step's 'pod' reduction: two steps with and without
    res["train_int8"] = _train(inp, pod2, 2, tcfg_kw={"grad_compression": "int8_ef"})
    res["train_int8_1"] = _train(inp, pod2, 1, tcfg_kw={"grad_compression": "int8_ef"})
    res["train_none"] = _train(inp, pod2, 2)
    return res


def case_mace_train(inp, meshes):
    """A MaceGaunt (shard_data off) trained two steps on (2, 1): each rank
    takes one of the two molecules and computes on the weights gathered
    whole; and a shard_data model, which the sharded loop refuses."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs.gaunt_ff import gaunt_mace_ff
    from repro_torch.models.equivariant import MaceGaunt
    from repro_torch.train import train_loop

    batch = {k: inp["mace_" + k] for k in ("species", "pos", "energy", "forces")}
    tcfg = TrainConfig(**inp["mace_tcfg"])
    res = {}
    for shard_data in (False, True):
        cfg = dataclasses.replace(gaunt_mace_ff, **inp["mace_cfg"], shard_data=shard_data)
        model = MaceGaunt(cfg, device="cpu")
        model.load_state_dict(inp["mace_state"])
        try:
            _, hist = train_loop(lambda m, b: (m.loss(b), {}), model, iter([batch] * 2), tcfg,
                                 hooks={"preemption": False}, mesh=meshes["2x1"])
            res[shard_data] = [(h["loss"], h["grad_norm"]) for h in hist]
        except ValueError as e:
            res[shard_data] = f"ValueError: {e}"
    return res


def case_elastic_twins(inp, meshes, d):
    """Twins of the reference's checkpoint_elastic_reshard,
    elastic_reshard_live_tree and elastic_restore_on_mesh, on (2, 1)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.elastic import reshard_tree, restore_on_mesh
    from repro_torch.distributed.sharding import placements

    mesh = meshes["2x1"]
    res = {}
    mgr = CheckpointManager(os.path.join(d, "ckpt_twin"))
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, tree, blocking=True)
    dist.barrier()
    pl = {"w": placements(("data", None), mesh)}
    restored, _ = mgr.restore(1, tree, shardings=pl, mesh=mesh)
    res["reshard"] = (restored["w"].full_tensor(), restored["w"].to_local(),
                      [str(p) for p in restored["w"].placements])
    live = {"layers": {"mlp": {"w_up": {"w": torch.ones(8, 16)}}}, "ln_f": {"scale": torch.ones(8)}}
    out = reshard_tree(live, mesh)
    res["live"] = (out["ln_f"]["scale"].full_tensor(),
                   tuple(out["layers"]["mlp"]["w_up"]["w"].device_mesh.mesh.shape),
                   [str(p) for p in out["layers"]["mlp"]["w_up"]["w"].placements])
    mgr.save(3, {"embed": {"embedding": torch.arange(32.0).reshape(4, 8)}}, blocking=True)
    dist.barrier()
    back, _ = restore_on_mesh(mgr, 3, {"embed": {"embedding": torch.zeros(4, 8)}}, mesh)
    res["restore_on_mesh"] = back["embed"]["embedding"].full_tensor()
    return res


def main(rank: int, world: int, d: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.engine import ShardSpec
    from repro_torch.launch.mesh import make_host_mesh

    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    torch.manual_seed(0)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    meshes = {"2x1": make_host_mesh(2, 1, device="cpu"),
              "1x2": init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))}
    spec = ShardSpec(meshes["2x1"])
    cases = {
        "chain": lambda: case_chain(inp, spec),
        "chain_shard_map": lambda: case_chain(inp, ShardSpec(meshes["2x1"], mode="shard_map")),
        "batch": lambda: case_batch(inp, spec),
        "conv": lambda: case_conv(inp, spec),
        "manybody": lambda: case_manybody(inp, spec),
        "selfmix": lambda: case_selfmix(inp, spec),
        "mace": lambda: case_mace(inp, meshes["2x1"]),
        "serve": lambda: case_serve(inp, meshes["2x1"]),
        "train": lambda: case_train(inp, meshes),
        "mace_train": lambda: case_mace_train(inp, meshes),
        "elastic_resume": lambda: case_elastic_resume(inp, meshes, d),
        "int8": lambda: case_int8(inp, rank),
        "elastic_twins": lambda: case_elastic_twins(inp, meshes, d),
    }
    out = {"jax_loaded": False}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 — the test reports the case's traceback
            out[name] = {"error": traceback.format_exc()}
        dist.barrier()
    out["jax_loaded"] = any(m == "jax" or m.startswith("jax.") or m == "repro"
                            or m.startswith("repro.") for m in sys.modules)
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
