"""The EquiformerV2 family: EquiformerV2 with the paper's Gaunt Selfmix,
served on OC20-sized adsorbate-slab systems with direct forces.

Everything the run kinds call for a configuration whose ``family`` is
``equiformer``:

- `shapes`, `make_weights`: its parameters, drawn from the seed
  (`perfbench.weights.draw`) at the stds of the configuration's ``init``;
- `build`: the port's ``EquiformerV2Gaunt`` at the configuration's ``model``;
- `reference`: the plain reference (`perfbench.equiformer_reference`:
  float64, plain PyTorch, nothing of the port);
- `molecules`: fcc(111) metal slabs with a small adsorbate (`slabs`);
- `serve_flops`: model FLOPs of one served evaluation (forward only: the
  forces are an output of the forward pass);
- `kernel_bounds`: the least time of the Selfmix chain's kernel calls in
  a traced window.

The port is imported inside `build` alone, so the reference and the
inputs load nothing of it.
"""
from __future__ import annotations

import numpy as np

from perfbench import weights, work
from perfbench.equiformer_reference import EquiformerReference

__all__ = ["shapes", "make_weights", "build", "reference", "molecules", "slabs",
           "edges", "forward_flops", "serve_flops", "kernel_bounds"]

# fcc metals of the slabs: element index (= atomic number) and lattice
# constant in A (room-temperature values)
METALS = ((29, 3.615), (46, 3.891), (47, 4.086), (78, 3.924), (79, 4.078))
ADSORBATE = (1, 6, 7, 8)                # H, C, N, O
SITES = 5                               # a layer is SITES x SITES sites
LAYERS = 4


def _radial(pre: str, n_in: int, c: int, n_out: int) -> dict:
    out = {}
    for i, (a, b) in enumerate([(n_in, c), (c, c)], start=1):
        out.update({f"{pre}rad_w{i}": (a, b), f"{pre}rad_b{i}": (b,),
                    f"{pre}rad_ln{i}_w": (b,), f"{pre}rad_ln{i}_b": (b,)})
    out.update({f"{pre}rad_w3": (c, n_out), f"{pre}rad_b3": (n_out,)})
    return out


def _sln(pre: str, m: dict) -> dict:
    C = m["channels"]
    return {f"{pre}ln_w": (C,), f"{pre}ln_b": (C,), f"{pre}sln_affine": (m["L"], C)}


def _attention(pre: str, m: dict, c_out: int) -> dict:
    L, M, C, Ec = m["L"], m["m_max"], m["channels"], m["edge_channels"]
    Ha, H, A = m["attn_hidden"], m["n_heads"], m["attn_alpha"]
    HV = H * m["attn_value"]
    extra = H * A + Ha
    out = {f"{pre}source_embedding": (m["n_species"], Ec),
           f"{pre}target_embedding": (m["n_species"], Ec)}
    out.update(_radial(pre, m["n_gaussians"] + 2 * Ec, Ec,
                       2 * C * sum(L + 1 - k for k in range(M + 1))))
    for conv, ci, co, ex in (("conv1", 2 * C, Ha, extra), ("conv2", Ha, HV, 0)):
        out[f"{pre}{conv}_m0_w"] = (ci * (L + 1), ex + co * (L + 1))
        out[f"{pre}{conv}_m0_b"] = (ex + co * (L + 1),)
        for k in range(1, M + 1):
            out[f"{pre}{conv}_m{k}_w"] = (ci * (L + 1 - k), 2 * co * (L + 1 - k))
    out.update({f"{pre}alpha_ln_w": (A,), f"{pre}alpha_ln_b": (A,), f"{pre}alpha_dot": (H, A),
                f"{pre}proj_w": (L + 1, HV, c_out), f"{pre}proj_b": (c_out,)})
    return out


def _ffn(pre: str, m: dict, c_out: int) -> dict:
    L, C, Fh = m["L"], m["channels"], m["ffn_hidden"]
    return {f"{pre}lin1_w": (L + 1, C, Fh), f"{pre}lin1_b": (Fh,),
            f"{pre}scalar_w": (C, Fh), f"{pre}scalar_b": (Fh,),
            f"{pre}grid_w1": (Fh, Fh), f"{pre}grid_w2": (Fh, Fh), f"{pre}grid_w3": (Fh, Fh),
            f"{pre}lin2_w": (L + 1, Fh, c_out), f"{pre}lin2_b": (c_out,)}


def shapes(m: dict) -> dict:
    """name -> shape of every parameter of the model at sizes ``m`` (the
    port's ``state_dict`` names)."""
    L, C, Ec = m["L"], m["channels"], m["edge_channels"]
    out = {"sphere_embedding": (m["n_species"], C),
           "edge_degree.source_embedding": (m["n_species"], Ec),
           "edge_degree.target_embedding": (m["n_species"], Ec)}
    out.update(_radial("edge_degree.", m["n_gaussians"] + 2 * Ec, Ec, C * (L + 1)))
    for b in range(m["n_layers"]):
        pre = f"blocks.{b}."
        out.update(_sln(pre + "norm_1.", m))
        out.update(_attention(pre + "ga.", m, C))
        out.update(_sln(pre + "norm_2.", m))
        out.update(_ffn(pre + "ffn.", m, C))
        out.update({pre + "selfmix.w1": (L + 1,), pre + "selfmix.w2": (L + 1,),
                    pre + "selfmix.w3": (2 * L + 1,), pre + "selfmix.mix": (L + 1, C, C)})
    out.update(_sln("norm.", m))
    out.update(_ffn("energy_block.", m, 1))
    out.update(_attention("force_block.", m, 1))
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    return weights.draw(shapes(cfg["model"]), cfg["init"], seed, device)


def build(cfg: dict, wts: dict, device):
    """The port's EquiformerV2Gaunt at the configuration, on ``wts`` (its
    chain picks persist where ``run.py`` points $REPRO_TORCH_AUTOTUNE_CACHE)."""
    from repro_torch.configs.gaunt_ff import EquiformerV2Config
    from repro_torch.models.equiformer import EquiformerV2Gaunt

    model = EquiformerV2Gaunt(EquiformerV2Config(name=cfg["name"], **cfg["model"]),
                              device=device)
    model.load_state_dict(wts)
    return model


def reference(cfg: dict, wts: dict, dtype, device) -> EquiformerReference:
    return EquiformerReference(cfg["model"], wts, dtype=dtype, device=device)


def _slab(a: float, n: int) -> np.ndarray:
    """The first ``n`` sites of an fcc(111) slab, layer by layer from the
    bottom (ABC stacking), each layer row by row: [n, 3]."""
    nn = a / np.sqrt(2.0)
    a1, a2 = np.array([nn, 0.0, 0.0]), np.array([0.5 * nn, 0.5 * np.sqrt(3.0) * nn, 0.0])
    dz = a / np.sqrt(3.0)
    out = [(k % 3) * (a1 + a2) / 3 + i * a1 + j * a2 + np.array([0.0, 0.0, k * dz])
           for k in range(LAYERS) for j in range(SITES) for i in range(SITES)]
    return np.asarray(out[:n])


def slabs(n_atoms: int, count: int, rng: np.random.Generator):
    """``count`` systems of ``n_atoms`` atoms (species int64 [count, n],
    pos float32 [count, n, 3]), each drawn in order from ``rng``:

    1. a metal of `METALS`, uniformly; its element index is its atomic
       number;
    2. an adsorbate size k uniform in 2..9 (at most n_atoms - 1), the slab
       the first n_atoms - k sites of `_slab` (5 x 5 sites a layer, at most
       4 layers);
    3. the k adsorbate atoms' elements, each H, C, N or O uniformly;
    4. their places one by one, each drawn again until it lies 1.0-3.5 A
       above the highest slab atom, over the middle of the layer's
       parallelogram (fractional coordinates 0.2-0.8 along each edge) and
       at least 1.0 A from every atom placed so far: the first a uniform
       point of that box (fractional coordinates, then height); each next
       one 1.1-1.5 A (uniform) from a uniformly chosen earlier adsorbate
       atom, in a uniform direction.

    Every atom of a system of 70-86 atoms then has at least 20 others
    within 12 A."""
    species = np.zeros((count, n_atoms), np.int64)
    pos = np.zeros((count, n_atoms, 3))
    for s in range(count):
        z_metal, a = METALS[rng.integers(len(METALS))]
        k = min(int(rng.integers(2, 10)), n_atoms - 1)
        base = _slab(a, n_atoms - k)
        top = base[:, 2].max()
        edge = a / np.sqrt(2.0) * SITES
        cell = np.array([[edge, 0.0], [0.5 * edge, 0.5 * np.sqrt(3.0) * edge]])
        inv = np.linalg.inv(cell.T)
        ads = [ADSORBATE[i] for i in rng.integers(len(ADSORBATE), size=k)]
        atoms = list(base)
        for j in range(k):
            while True:
                if j == 0:
                    u, v = rng.uniform(0.2, 0.8, 2)
                    p = np.array([*(u * cell[0] + v * cell[1]), top + rng.uniform(1.0, 3.5)])
                else:
                    d = rng.normal(size=3)
                    p = (atoms[n_atoms - k + int(rng.integers(j))]
                         + rng.uniform(1.1, 1.5) * d / np.linalg.norm(d))
                uv = inv @ p[:2]
                if (1.0 <= p[2] - top <= 3.5 and np.all((uv >= 0.2) & (uv <= 0.8))
                        and np.linalg.norm(np.asarray(atoms) - p, axis=1).min() >= 1.0):
                    break
            atoms.append(p)
        species[s, :n_atoms - k] = z_metal
        species[s, n_atoms - k:] = ads
        pos[s] = np.asarray(atoms)
    return species, pos.astype(np.float32)


def molecules(mix: dict, n_atoms: int, count: int, seed: int):
    """(species int64 [count, n_atoms], pos float32 [count, n_atoms, 3]):
    adsorbate-slab systems (`slabs`) from the seed and the size."""
    return slabs(n_atoms, count, np.random.default_rng([seed, 3, n_atoms]))


def edges(m: dict, n_atoms: int) -> int:
    """Edges of one system: each atom's max_neighbors nearest (the slab
    systems give every atom that many within the cutoff; a system of fewer
    atoms, all of its others)."""
    return n_atoms * min(m["max_neighbors"], n_atoms - 1)


def forward_flops(m: dict, n_atoms: int) -> int:
    """Forward FLOPs of one system of ``n_atoms`` atoms at sizes ``m``: 2 a
    multiply-add over the matrix products and contractions.

    Per edge and attention block (the 12 blocks and the force head):
    the radial MLP; the rotation into the edge frame of 2C channels and
    back of H V (each degree's (2l+1) x min(2l+1, 2M+1) rows); SO(2) conv 1
    and conv 2 (m = 0 one map, m > 0 the same map on +m and -m); the S^2
    activation's to and from grid on the (L, M) grid (G = res^2 points);
    the alpha dot.  Per atom and attention block: the output map.  Per
    atom and FFN (12 and the energy head): lin 1, the scalar MLP, to grid,
    the three grid Linears, from grid, lin 2.  Per atom and block: the
    Selfmix chain (`work.chain_work`'s count, 2 operands, ungated) on C
    rows, its two per-operand weights (a multiply a coefficient) and its
    channel mix.  Once: the edge-degree
    embedding's radial MLP and its m = 0 rotation back.  Norms, softmax,
    activations and the geometry are not counted."""
    L, M, C = m["L"], m["m_max"], m["channels"]
    Ha, H, A, V = m["attn_hidden"], m["n_heads"], m["attn_alpha"], m["attn_value"]
    Ec, Fh, G = m["edge_channels"], m["ffn_hidden"], m["grid_res"] ** 2
    D = (L + 1) ** 2
    n_e = sum(2 * min(l, M) + 1 for l in range(L + 1))     # edge-frame coefficients
    rot = sum((2 * l + 1) * (2 * min(l, M) + 1) for l in range(L + 1))
    n_in = m["n_gaussians"] + 2 * Ec
    ls = [L + 1 - k for k in range(M + 1)]                  # degrees of order k

    def radial(n_out):
        return n_in * Ec + Ec * Ec + Ec * n_out

    def so2(ci, co, extra):
        return ci * ls[0] * (extra + co * ls[0]) + sum(2 * ci * n * 2 * co * n for n in ls[1:])

    def attention_edge():
        return (radial(2 * C * sum(ls)) + rot * 2 * C + so2(2 * C, Ha, H * A + Ha)
                + 2 * G * n_e * Ha + so2(Ha, H * V, 0) + rot * H * V + H * A)

    def ffn_atom(c_out):
        return D * C * Fh + C * Fh + 2 * G * D * Fh + 3 * G * Fh * Fh + D * Fh * c_out

    chain_f, _ = work.chain_work(C, L, 2, L, gated=False)
    e = edges(m, n_atoms)
    macs = (m["n_layers"] * (e * attention_edge() + n_atoms * (D * H * V * C + ffn_atom(C)
                                                                + D * C * C))
            + e * attention_edge() + n_atoms * (D * H * V + ffn_atom(1))
            + e * (radial(C * (L + 1)) + C * D))
    return 2 * macs + m["n_layers"] * n_atoms * (chain_f + 2 * C * D)


def serve_flops(cfg: dict, n_atoms: int) -> int:
    """Model FLOPs of one served evaluation of ``n_atoms`` atoms: the forward
    pass alone (the forces are its output)."""
    return forward_flops(cfg["model"], n_atoms)


def kernel_bounds(cfg: dict, buckets: list) -> dict:
    """{"gaunt_chain": {bound_s, launches}} over a traced window: each
    bucket ({n_slots, max_atoms, launches a replay, replays}) adds its
    replays times its chain launches a replay, each call the 2-operand
    Selfmix chain on the bucket's rows (n_slots x max_atoms x channels)."""
    m = cfg["model"]
    total_s, launches = 0.0, 0
    for b in buckets:
        calls = b["replays"] * b["launches"].get("gaunt_chain", 0)
        rows = b["n_slots"] * b["max_atoms"] * m["channels"]
        f, nbytes = work.chain_work(rows, m["L"], 2, m["L"], gated=False)
        total_s += calls * work.bound_s(f, nbytes)
        launches += calls
    return {"gaunt_chain": {"bound_s": total_s, "launches": launches}}
