"""The paper's own model configs: Gaunt-accelerated equivariant networks —
the MACE-like force field, the SEGNN-like N-body net and the EquiformerV2
Selfmix layer.

`EquivariantConfig` is a copy of the reference ``repro.configs.gaunt_ff``
with every knob.  `EquiformerV2Config` (the port's own, not in the
reference) is the whole EquiformerV2 with the paper's Gaunt Selfmix in
each block (`models.equiformer.EquiformerV2Gaunt`), and
`gaunt_equiformer_v2_oc20` its OC20 S2EF-2M widths (arXiv:2306.12059).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EquivariantConfig:
    name: str
    kind: str            # mace | segnn | equiformer_selfmix
    L: int = 2           # max feature degree
    L_edge: int = 2      # SH filter degree
    channels: int = 64
    n_layers: int = 2
    n_species: int = 8
    nu: int = 3          # many-body order (MACE)
    cutoff: float = 5.0
    n_radial: int = 8
    tp_impl: str = "gaunt"    # gaunt | gaunt_fused | gaunt_auto | cg
    conv_impl: str = "escn"   # escn | general (the paper's 2D Fourier convolution)
    hidden: int = 128
    # split the rows of every product (the conv, the pairwise product, the
    # many-body chain) over the activation mesh's data-parallel ranks
    # (`distributed.sharding.set_activation_mesh`); without a registered
    # mesh the model runs unsharded
    shard_data: bool = False
    # keep the layer-constant edge geometry resident: the general conv's
    # filter grid (`EquivariantConv.filter_rep`), or the eSCN alignment
    # rotation and Wigner recursion, built once per geometry, not per layer
    fourier_resident: bool = True
    # chain-backend policy: 'heuristic' keeps the spectral tree, 'measure'
    # times the chain backends (tree vs the collocation kernel) at the real
    # row count and keeps the faster
    chain_tune: str = "heuristic"
    # storage dtype of the many-body chain ('float32' | 'bfloat16';
    # 'float64' on the plain path): operands and sampling matrices at this
    # dtype, sums in f32, the chain exit at it; the conv, the mixes and the
    # gate stay f32.  'auto' with chain_tune='measure' times both storage
    # dtypes per chain key and keeps bf16 only where it wins (float32
    # otherwise)
    compute_dtype: str = "float32"
    # 'on' fuses the gate into the many-body chain (gate-before-mb_mix, a
    # reparameterization: fix it per checkpoint) and, in SEGNN, evaluates
    # the gate on the S^2 quadrature grid; 'off' gates in SH after the
    # mb_mix channel mix; 'auto' asks the engine's measured gate policy
    # (`GauntEngine.select_gate`) and needs chain_tune='measure' (else off)
    grid_gate: str = "off"
    # serve bucket ladder: ((max_atoms, n_slots), ...) for
    # `EquivariantServeEngine` when it gets no ``buckets`` argument (None:
    # one bucket of the engine's max_atoms x n_slots); each bucket has its
    # own step — on CUDA its own captured graph — for its padded shape
    serve_buckets: tuple[tuple[int, int], ...] | None = None
    # persistent autotune cache file (`core/autotune_cache.py`): serve
    # warmup loads it first, so a warm host seeds every bucket's chain keys
    # with zero timing runs.  None: $REPRO_TORCH_AUTOTUNE_CACHE, else off.
    # Pre-populate with `python -m repro_torch.core.autotune_cache --cache <path>`.
    autotune_cache: str | None = None


gaunt_mace_ff = EquivariantConfig(
    name="gaunt-mace-ff", kind="mace", L=2, L_edge=3, channels=64, n_layers=2, nu=3
)
gaunt_segnn_nbody = EquivariantConfig(
    name="gaunt-segnn-nbody", kind="segnn", L=1, L_edge=1, channels=32, n_layers=4
)
gaunt_equiformer_selfmix = EquivariantConfig(
    name="gaunt-equiformer-selfmix", kind="equiformer_selfmix", L=4, L_edge=4,
    channels=32, n_layers=2
)


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    """EquiformerV2 (arXiv:2306.12059) with the Gaunt Selfmix after each
    block's feed-forward residual; the keys are the paper's hyper-parameters."""
    name: str
    L: int = 6                 # l_max
    m_max: int = 2             # orders kept in the edge frame
    channels: int = 128        # sphere channels
    n_layers: int = 12
    n_heads: int = 8
    attn_hidden: int = 64      # SO(2) conv 1's output channels
    attn_alpha: int = 64       # alpha channels a head
    attn_value: int = 16       # value channels a head
    ffn_hidden: int = 128
    grid_res: int = 18         # S^2 grid: res latitudes x res longitudes
    edge_channels: int = 128
    n_species: int = 90
    cutoff: float = 12.0
    max_neighbors: int = 20
    n_gaussians: int = 600
    # from the public EquiformerV2 code, not the paper's table: the Gaussian
    # width in basis spacings, the average atom count (energy scale) and the
    # average degree (the edge-degree embedding's scale)
    gaussian_width: float = 2.0
    avg_num_nodes: float = 77.81684
    avg_degree: float = 23.395238876342773
    # the Selfmix chain's backend policy, as `SelfmixLayer` takes it, and
    # the model's precision (only 'float32': a key so the configuration
    # states it)
    chain_tune: str = "heuristic"
    compute_dtype: str = "float32"
    autotune_cache: str | None = None  # as `EquivariantConfig.autotune_cache`


gaunt_equiformer_v2_oc20 = EquiformerV2Config(name="gaunt-equiformer-v2-oc20",
                                              chain_tune="measure")
