"""The yardstick's counts against hand counts, and the copied molecule
generator against the port's."""
import numpy as np
import pytest

from perfbench import lj, work


def test_gaunt_nonzeros_by_hand():
    # Y00 times Y_b is Y_b / sqrt(4 pi): one nonzero per b, each its own pair
    assert work.gaunt_nonzeros(0, 1, 1) == (4, 4)
    # (1, 1) -> 0: only a == b survives, 4 nonzeros over 4 pairs
    assert work.gaunt_nonzeros(1, 1, 0) == (4, 4)


def test_chain_work_by_hand():
    """nu = 2, L = 1, Lout = 0, ungated: the one step (1, 1, 0) has 4 pairs and
    4 nonzeros, so 4 + 2 * 4 = 12 FLOPs a row; bytes: two operands of 4 and
    one output of 1 float32 a row, and 4 nonzero values."""
    f, b = work.chain_work(10, L=1, nu=2, Lout=0, gated=False)
    assert f == 10 * 12
    assert b == 4 * (10 * (4 + 4 + 1) + 4)
    # gated: one multiply per output coefficient and one add; two scalars read
    fg, bg = work.chain_work(10, L=1, nu=2, Lout=0, gated=True)
    assert fg == 10 * (12 + 1 + 1)
    assert bg == b + 4 * 10 * 2


def test_forward_flops_by_hand():
    """L = 0, C = 1, n_radial = 1, hidden = 1, one layer, nu = 2, two atoms."""
    m = dict(L=0, channels=1, n_radial=1, hidden=1, nu=2, n_layers=1)
    radial = 2 * (1 * 32 + 32 * 1)                  # 128
    edge_channel = 1 + 2 * 2 + 2 + 2                # weight, rotations, aligned, sum
    chain = 1 + 2 * 1 + 1 + 1                       # (0,0,0): 1 pair, 1 nonzero; gate
    atom = 2 * 2 * 1 * 1 + (chain + 2 * 1) + 2 * 64 + 1
    expected = 2 * (radial + edge_channel) + 2 * atom + 2 * 2 * (1 + 1)
    assert work.forward_flops(m, 2) == expected
    assert work.serve_flops(m, 2) == 2 * expected
    assert work.train_flops(m, 2) == 6 * expected


def test_bound_takes_the_larger_side():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("n_atoms", [8, 27, 29])
def test_lj_copy_equals_the_port(n_atoms):
    from repro_torch.data import molecules

    a = lj.lj_dataset(3, n_atoms, 4, seed=[5, n_atoms])
    b = molecules.lj_dataset(3, n_atoms, 4, seed=[5, n_atoms])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
