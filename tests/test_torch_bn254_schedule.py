"""The ``bn254`` kernel's team schedule on the CPU (``ops/bn254_schedule``):

- the committed header ``csrc/bn254_schedule.cuh`` is what the generator
  writes, byte for byte;
- every round of each step is race-free (no thread reads or writes a slot
  another thread writes in it) and every position is multiplies only or
  linear operations only, at the kernel's team of 8 and at a team of 4;
- the lane's slots fit the shared-memory budget the kernel is sized for;
- the team model (the tables run over Python ints, slot by slot) gives
  Miller values equal mod P to the plain version ``miller_values_plain`` on
  edge lanes (the padding lane, coordinates 0, 1 and P - 1, off-curve
  field elements) and on seeded lanes. tests/test_torch_bn254.py holds
  the model to the reference's JAX program too.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import bn254_pure as pure
from cometbft_tpu_torch.ops import bn254_kernel as bk
from cometbft_tpu_torch.ops import bn254_schedule as bs

pytestmark = pytest.mark.torch_port

P = pure.P


def edge_lanes():
    rng = np.random.default_rng(7)

    def fe():
        return int.from_bytes(rng.bytes(32), "little") % P

    return [(pure.G1, pure.G2), ((0, 0), ((0, 0), (0, 0))), ((1, 1), ((1, 1), (1, 1))),
            ((P - 1, P - 1), ((P - 1, P - 1), (P - 1, P - 1))), ((0, 1), ((P - 1, 0), (1, P - 1))),
            ((fe(), fe()), ((fe(), fe()), (fe(), fe()))), ((fe(), fe()), pure.G2)]


def seeded_lanes(seed, n):
    p, q = pure._g1_mul(seed, pure.G1), pure._g2_mul(seed + 1, pure.G2)
    out = []
    for _ in range(n):
        out.append((p, q))
        p, q = pure._g1_add(p, pure.G1), pure._g2_add(q, pure.G2)
    return out


def plain_values(lanes):
    ops = bk.operands_to_device(bk._pack(lanes, len(lanes)), "cpu")
    ints = bk.limbs_to_ints(bk.miller_values_plain(*ops).numpy())
    return [tuple((int(v[k, 0]), int(v[k, 1])) for k in range(6)) for v in ints]


def test_header_is_the_generators_byte_for_byte():
    assert bs.HEADER.read_text() == bs.header()


@pytest.mark.parametrize("team", [8, 4])
@pytest.mark.parametrize("step", ["doubling", "addition"])
def test_every_round_is_race_free(step, team):
    s = bs.steps(team)[step == "addition"]
    bs.check_races(s, team)
    assert all(len(row) == team for row in s.entries)
    mul_positions = sum(any(e is not None and e[0] == bs.MUL for e in row) for row in s.entries)
    assert mul_positions >= -(-s.muls // team)
    assert sum(e is not None and e[0] == bs.MUL for row in s.entries for e in row) == s.muls


def test_step_counts_and_slot_budget():
    dbl, add = bs.steps()
    # f^2 (6 squares of 2, 15 Karatsuba products of 3), the doubling 34,
    # the line 54; the addition 40, the line 54
    assert (dbl.muls, add.muls) == (57 + 34 + 54, 40 + 54)
    assert bs.lane_muls() == 64 * dbl.muls + 38 * add.muls + 26
    assert len(bs.ATE_BITS) == 64 and sum(bs.ATE_BITS) == 36
    assert bs.slots() <= bs.SLOT_BUDGET
    table_bytes = 4 * len(dbl.words() + add.words())
    assert 63 * bs.SLOT_BUDGET * 32 + table_bytes <= 232_448  # 227 KB a block
    assert max(e[1] for s in (dbl, add) for row in s.entries for e in row if e) < bs.slots()


@pytest.mark.parametrize("lanes", ["edge", "seeded"])
def test_team_model_equals_plain(lanes):
    pairs = edge_lanes() if lanes == "edge" else seeded_lanes(12_345, 3)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = plain_values(pairs)
    finally:
        torch.set_num_threads(prev)
    assert bs.miller_values_model(pairs) == want


def test_team_of_four_model_equals_team_of_eight():
    pairs = edge_lanes()[:3]
    assert bs.miller_values_model(pairs, team=4) == bs.miller_values_model(pairs)
