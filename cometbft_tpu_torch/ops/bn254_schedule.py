"""The team schedule of the ``bn254`` kernel: its generator and a Python
model of the team that runs it.

The kernel (``csrc/bn254.cu``) runs one Miller lane on a team of ``TEAM``
threads of one warp. A lane's Fp elements sit in shared memory, one slot
of eight 32-bit Montgomery words each; a step of the ate loop (a doubling
step: f^2, the doubling of T and its tangent, f times the tangent; an
addition step: T + Q, its chord, f times the chord) is a fixed table of
positions. At a position every thread of the team does one operation on
slots named by its own entry: a Montgomery multiply, an add or subtract
mod p, or nothing; a round is a run of positions that ends in
``__syncwarp`` over the team. No thread reads in a round what another
thread writes in it, and a position holds multiplies only or linear
operations only, so no warp diverges beyond its idle threads.

The generator builds each step as a graph of Fp operations (Fp2 products
by Karatsuba, squares as (a + b)(a - b) + 2ab u, f^2 by its 21 symmetric
Fp2 products folded through w^6 = xi, the line product by its 18), lists
it greedily by critical path (multiplies first, up to ``TEAM`` a round;
then linear positions), and gives each value a slot (the lane's state in
fixed slots, temporaries in the lowest slot free after their last
reader's round). ``header()`` emits the tables as ``csrc/
bn254_schedule.cuh``, which is committed; ``python -m
cometbft_tpu_torch.ops.bn254_schedule`` rewrites it. ``miller_values_model``
runs the same tables over Python ints, thread by thread and round by
round, and ``check_races`` holds every round to the rule above, so the
arithmetic and the schedule are tested on the CPU.

The values are the plain version's (``bn254_kernel.miller_values_plain``)
in Fp12 exactly: the same Jacobian formulas, the tangent scaled by Z^6 and
the chord by Z^3, c1 = -(.) xp as (.) (-xp) and c0 = 2 (.) yp as (.) (2 yp).
"""

from __future__ import annotations

import heapq
from pathlib import Path

from cometbft_tpu_torch.crypto import bn254_pure as _b

P = _b.P
R_MONT = 1 << 256
R_INV = pow(R_MONT, -1, P)

TEAM = 8  # threads a lane: a power of two, at most 32

NOP, MUL, ADD, SUB = 0, 1, 2, 3
SYNC = 1 << 31
MUL_COST, LIN_COST = 8, 1  # a position's relative time, for the list scheduler

# The lane's state: f (f_k = F[2k] + F[2k + 1] u), T = (X, Y, Z) Jacobian,
# the point Q being added (Q, then pi(Q), then -pi^2(Q)), yp, 2 yp, -xp.
SLOT_F, SLOT_X, SLOT_Y, SLOT_Z, SLOT_Q = 0, 12, 14, 16, 18
SLOT_YP, SLOT_YP2, SLOT_NXP = 22, 23, 24
FIXED_SLOTS = 25

# 6t + 2 below its top bit, MSB first: a doubling step each, an addition
# step after each set bit; then additions of pi(Q) and -pi^2(Q).
ATE_BITS = [1 if c == "1" else 0 for c in bin(_b._ATE_LOOP)[3:]]
# Fp multiplies a lane outside the steps: P's two and Q's four coordinates
# into Montgomery form, pi(Q)'s and -pi^2(Q)'s four each, f's twelve out.
CONVERSIONS = 2 + 4 + 4 + 4 + 12

HEADER = Path(__file__).resolve().parent / "csrc" / "bn254_schedule.cuh"


# -- the step graphs -----------------------------------------------------------


class _Graph:
    """Fp operations of one step, shared where equal (commuting operands
    sorted). Nodes: ("in", slot) for the state read at the step's start,
    else (op, a, b) over node ids."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self._ids: dict[tuple, int] = {}
        self.outputs: dict[int, int] = {}  # fixed slot -> node written there

    def _node(self, key):
        if key not in self._ids:
            self._ids[key] = len(self.nodes)
            self.nodes.append(key)
        return self._ids[key]

    def inp(self, slot):
        return self._node(("in", slot))

    def op(self, kind, a, b):
        if kind in (MUL, ADD) and a > b:
            a, b = b, a
        return self._node((kind, a, b))

    # Fp2 = (a, b) node pairs, u^2 = -1
    def add2(self, x, y):
        return (self.op(ADD, x[0], y[0]), self.op(ADD, x[1], y[1]))

    def sub2(self, x, y):
        return (self.op(SUB, x[0], y[0]), self.op(SUB, x[1], y[1]))

    def dbl2(self, x):
        return self.add2(x, x)

    def mul2(self, x, y):
        if x == y:  # (a + b u)^2 = (a + b)(a - b) + 2 a b u
            ab = self.op(MUL, x[0], x[1])
            return (self.op(MUL, self.op(ADD, x[0], x[1]), self.op(SUB, x[0], x[1])),
                    self.op(ADD, ab, ab))
        m0 = self.op(MUL, x[0], y[0])
        m1 = self.op(MUL, x[1], y[1])
        m2 = self.op(MUL, self.op(ADD, x[0], x[1]), self.op(ADD, y[0], y[1]))
        return (self.op(SUB, m0, m1), self.op(SUB, self.op(SUB, m2, m0), m1))

    def mul2_fp(self, x, s):
        return (self.op(MUL, x[0], s), self.op(MUL, x[1], s))

    def xi2(self, x):
        """x (9 + u) = (9 a - b) + (a + 9 b) u."""
        def nine(v):
            v8 = self.op(ADD, v, v)
            v8 = self.op(ADD, v8, v8)
            v8 = self.op(ADD, v8, v8)
            return self.op(ADD, v8, v)
        return (self.op(SUB, nine(x[0]), x[1]), self.op(ADD, x[0], nine(x[1])))

    def sum2(self, terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = self.add2(acc, t)
        return acc

    def fp2_in(self, slot):
        return (self.inp(slot), self.inp(slot + 1))

    def out2(self, slot, x):
        self.outputs[slot], self.outputs[slot + 1] = x

    def f12_sqr(self, f):
        """f^2: the 21 products f_i f_j (i <= j, cross terms doubled), by
        k = (i + j) mod 6; i + j >= 6 folds through w^6 = xi."""
        g = []
        for k in range(6):
            parts = {False: ([], []), True: ([], [])}  # hi -> (squares, cross)
            for i in range(6):
                for j in range(i, 6):
                    if (i + j) % 6 == k:
                        parts[i + j >= 6][i != j].append(self.mul2(f[i], f[j]))
            halves = []
            for hi in (False, True):
                sq, cross = parts[hi]
                terms = list(sq)
                if cross:
                    terms.append(self.dbl2(self.sum2(cross)))
                halves.append(self.sum2(terms) if terms else None)
            lo, hi_ = halves
            g.append(lo if hi_ is None else self.add2(lo, self.xi2(hi_)) if lo else self.xi2(hi_))
        return g

    def f12_mul_line(self, f, c0, c1, c3):
        """f (c0 + c1 w + c3 w^3)."""
        g = []
        for k in range(6):
            lo = [self.mul2(f[k], c0)]
            hi = []
            (lo if k >= 1 else hi).append(self.mul2(f[(k - 1) % 6], c1))
            (lo if k >= 3 else hi).append(self.mul2(f[(k - 3) % 6], c3))
            lo_s = self.sum2(lo)
            g.append(self.add2(lo_s, self.xi2(self.sum2(hi))) if hi else lo_s)
        return g


def _state(g: _Graph):
    f = [g.fp2_in(SLOT_F + 2 * k) for k in range(6)]
    return f, g.fp2_in(SLOT_X), g.fp2_in(SLOT_Y), g.fp2_in(SLOT_Z)


def _set_f(g: _Graph, f):
    for k in range(6):
        g.out2(SLOT_F + 2 * k, f[k])


def dbl_graph() -> _Graph:
    """A doubling step: f^2 and the doubling of T (independent), then f
    times the tangent at P scaled by Z^6: c0 = 2 Y Z^3 yp,
    c1 = -3 X^2 Z^2 xp, c3 = 3 X^3 - 2 Y^2 (bn254_kernel._dbl_and_line)."""
    g = _Graph()
    f, X, Y, Z = _state(g)
    yp2, nxp = g.inp(SLOT_YP2), g.inp(SLOT_NXP)
    f2 = g.f12_sqr(f)
    A, B, Z2 = g.mul2(X, X), g.mul2(Y, Y), g.mul2(Z, Z)
    C = g.mul2(B, B)
    xb = g.add2(X, B)
    XB, Z3p, YZ = g.mul2(xb, xb), g.mul2(Z2, Z), g.mul2(Y, Z)
    D = g.dbl2(g.sub2(g.sub2(XB, A), C))
    E = g.add2(g.dbl2(A), A)
    F2, EZ2, AX, YZ3 = g.mul2(E, E), g.mul2(E, Z2), g.mul2(A, X), g.mul2(Y, Z3p)
    X3 = g.sub2(F2, g.dbl2(D))
    c3 = g.sub2(g.add2(g.dbl2(AX), AX), g.dbl2(B))
    c0, c1 = g.mul2_fp(YZ3, yp2), g.mul2_fp(EZ2, nxp)
    Y3 = g.sub2(g.mul2(E, g.sub2(D, X3)), g.dbl2(g.dbl2(g.dbl2(C))))
    g.out2(SLOT_X, X3)
    g.out2(SLOT_Y, Y3)
    g.out2(SLOT_Z, g.dbl2(YZ))
    _set_f(g, g.f12_mul_line(f2, c0, c1, c3))
    return g


def add_graph() -> _Graph:
    """An addition step: T + Q (Q affine, mixed Jacobian), then f times the
    chord through Q at P scaled by Z^3: c0 = H Z yp, c1 = -r xp,
    c3 = r xq - yq H Z (bn254_kernel._add_and_line)."""
    g = _Graph()
    f, X, Y, Z = _state(g)
    xq, yq = g.fp2_in(SLOT_Q), g.fp2_in(SLOT_Q + 2)
    yp, nxp = g.inp(SLOT_YP), g.inp(SLOT_NXP)
    Z2 = g.mul2(Z, Z)
    Z3p, U2 = g.mul2(Z2, Z), g.mul2(xq, Z2)
    S2 = g.mul2(yq, Z3p)
    H, r = g.sub2(U2, X), g.sub2(S2, Y)
    H2, rsq, ZH = g.mul2(H, H), g.mul2(r, r), g.mul2(Z, H)
    H3, V = g.mul2(H2, H), g.mul2(X, H2)
    c3 = g.sub2(g.mul2(r, xq), g.mul2(yq, ZH))
    c0, c1 = g.mul2_fp(ZH, yp), g.mul2_fp(r, nxp)
    X3 = g.sub2(g.sub2(rsq, H3), g.dbl2(V))
    Y3 = g.sub2(g.mul2(r, g.sub2(V, X3)), g.mul2(Y, H3))
    g.out2(SLOT_X, X3)
    g.out2(SLOT_Y, Y3)
    g.out2(SLOT_Z, ZH)
    _set_f(g, g.f12_mul_line(f, c0, c1, c3))
    return g


# -- list scheduling and slots ---------------------------------------------------


class Schedule:
    """A step's positions: ``entries[p][t]`` is (op, dst, a, b) or None for
    thread t at position p; ``sync[p]`` ends a round. ``muls`` counts the
    step's multiplies, ``slots`` the slots it needs (fixed ones included)."""

    def __init__(self, entries, sync, muls, slots):
        self.entries, self.sync, self.muls, self.slots = entries, sync, muls, slots

    def words(self) -> list[int]:
        out = []
        for p, row in enumerate(self.entries):
            for e in row:
                w = 0 if e is None else e[0] << 24 | e[1] << 16 | e[2] << 8 | e[3]
                out.append(w | (SYNC if self.sync[p] else 0))
        return out


def schedule(g: _Graph, team: int = TEAM, min_fill: int = 4, urgent: int = 1,
             quant: int = 1) -> Schedule:
    """List-schedule a step for a team of ``team``. Multiplies go by
    critical path (in steps of ``quant``, then graph order), up to ``team``
    a round. After them, a linear position is added while it holds
    ``min_fill`` operations or one that reaches a multiply through at most
    ``urgent`` further linear ones; linear operations go by critical
    path."""
    nodes = g.nodes
    n = len(nodes)
    users = [[] for _ in range(n)]
    for i, nd in enumerate(nodes):
        if nd[0] != "in":
            for a in {nd[1], nd[2]}:
                users[a].append(i)
    out_node = {v: s for s, v in g.outputs.items()}
    # an op writing a fixed slot waits for every reader of the slot's old value
    war = {v: users[g._ids[("in", s)]] if ("in", s) in g._ids else [] for s, v in g.outputs.items()}
    cost = [0 if nd[0] == "in" else MUL_COST if nd[0] == MUL else LIN_COST for nd in nodes]
    prio = [0] * n
    to_mul = [n] * n  # linear hops from node i to a multiply that reads it
    for i in reversed(range(n)):
        prio[i] = cost[i] + max((prio[u] for u in users[i]), default=0)
        to_mul[i] = min((0 if nodes[u][0] == MUL else to_mul[u] + 1 for u in users[i]), default=n)

    done_round = {i: -1 for i, nd in enumerate(nodes) if nd[0] == "in"}
    thread_of = {}
    pending = {i for i, nd in enumerate(nodes) if nd[0] != "in"}
    rounds = []  # each: list of positions, each a list of team node ids (or None)
    r = 0

    def ready(i, allow_thread=None):
        """Ready this round: inputs from earlier rounds, or (allow_thread)
        from earlier positions of this round on that one thread; the
        slot's old readers (for an output) in earlier rounds."""
        owner = None
        for a in (nodes[i][1], nodes[i][2]):
            d = done_round.get(a)
            if d is None:
                return False, None
            if d == r:
                if allow_thread is None or (owner is not None and owner != thread_of[a]):
                    return False, None
                owner = thread_of[a]
        for u in war.get(i, ()):
            if u != i and done_round.get(u, r) >= r:
                return False, None
        return True, owner

    while pending:
        positions = []
        muls = sorted((i for i in pending if nodes[i][0] == MUL and ready(i)[0]),
                      key=lambda i: (-(prio[i] // quant), i))[:team]
        if muls:
            row = muls + [None] * (team - len(muls))
            for t, i in enumerate(muls):
                done_round[i], thread_of[i] = r, t
                pending.discard(i)
            positions.append(row)
        while True:
            cands = []
            for i in pending:
                if nodes[i][0] == MUL:
                    continue
                ok, owner = ready(i, allow_thread=True)
                if ok:
                    cands.append((-prio[i], i, owner))
            if not cands:
                break
            cands.sort()
            row, used = [None] * team, set()
            for _, i, owner in cands:
                t = owner if owner is not None else next((t for t in range(team) if t not in used), None)
                if t is None or t in used:
                    continue
                row[t] = i
                used.add(t)
            chosen = [i for i in row if i is not None]
            if (positions and len(chosen) < min_fill and min(to_mul[i] for i in chosen) > urgent
                    and any(nodes[i][0] == MUL for i in pending)):
                break
            for t, i in enumerate(row):
                if i is not None:
                    done_round[i], thread_of[i] = r, t
                    pending.discard(i)
            positions.append(row)
        if not positions:
            raise RuntimeError("bn254 schedule: no operation is ready")
        rounds.append(positions)
        r += 1

    # slots: fixed for the state; a temporary takes a state slot between its
    # old value's last reader and its new value's writer when its life fits
    # there, else the lowest slot free after its last reader's round
    last_use = {}
    for i, nd in enumerate(nodes):
        if nd[0] != "in":
            for a in (nd[1], nd[2]):
                last_use[a] = max(last_use.get(a, -1), done_round[i])
    slot = {i: nd[1] for i, nd in enumerate(nodes) if nd[0] == "in"}
    slot.update(out_node)
    window = {s: (last_use.get(g._ids.get(("in", s)), -1) + 1, done_round[v] - 1)
              for s, v in g.outputs.items()}
    held = {s: -1 for s in window}  # round until which a temporary holds it
    free_at: list[tuple[int, int]] = []  # (round after which it is free, slot)
    free: list[int] = []
    next_slot = FIXED_SLOTS
    order = sorted((done_round[i], i) for i in range(n) if nodes[i][0] != "in")
    for rd, i in order:
        while free_at and free_at[0][0] < rd:
            heapq.heappush(free, heapq.heappop(free_at)[1])
        if i in slot:
            continue
        end = last_use.get(i, rd)
        fit = [s for s, (lo, hi) in window.items() if lo <= rd and end <= hi and held[s] < rd]
        if fit:
            slot[i] = min(fit)
            held[slot[i]] = end
        else:
            if free:
                slot[i] = heapq.heappop(free)
            else:
                slot[i], next_slot = next_slot, next_slot + 1
            heapq.heappush(free_at, (end, slot[i]))
    entries, sync = [], []
    for positions in rounds:
        for k, row in enumerate(positions):
            entries.append([None if i is None else (nodes[i][0], slot[i], slot[nodes[i][1]],
                                                    slot[nodes[i][2]]) for i in row])
            sync.append(k == len(positions) - 1)
    muls = sum(1 for nd in nodes if nd[0] == MUL)
    return Schedule(entries, sync, muls, next_slot)


# Each step's list-scheduling knobs: the least cost (a multiply position 8,
# a linear one 1) whose slots fit SLOT_BUDGET, over min_fill 1-8, urgent
# -1 to 99 and quant 1 to 64, at TEAM = 8.
DBL_KNOBS = dict(min_fill=4, urgent=-1, quant=64)
ADD_KNOBS = dict(min_fill=8, urgent=0, quant=4)
# Slots a lane may use: 63 lanes a block (8,192 lanes on 132 SMs in one
# wave) of SLOT_BUDGET x 32 bytes, and the tables, in 227 KB.
SLOT_BUDGET = 104

_CACHE: dict[int, tuple[Schedule, Schedule]] = {}


def steps(team: int = TEAM) -> tuple[Schedule, Schedule]:
    """(doubling step, addition step) schedules for a team of ``team``."""
    if team not in _CACHE:
        _CACHE[team] = (schedule(dbl_graph(), team, **DBL_KNOBS),
                        schedule(add_graph(), team, **ADD_KNOBS))
    return _CACHE[team]


def slots(team: int = TEAM) -> int:
    return max(s.slots for s in steps(team))


def lane_muls(team: int = TEAM) -> int:
    """Fp multiplies a lane: the steps' and the conversions."""
    dbl, add = steps(team)
    return len(ATE_BITS) * dbl.muls + (sum(ATE_BITS) + 2) * add.muls + CONVERSIONS


def check_races(s: Schedule, team: int = TEAM) -> None:
    """Raise unless, in every round, no thread reads or writes a slot that
    another thread writes, and every position holds multiplies only or
    linear operations only."""
    reads = [set() for _ in range(team)]
    writes = [set() for _ in range(team)]
    for p, row in enumerate(s.entries):
        kinds = {e[0] == MUL for e in row if e is not None}
        if len(kinds) > 1:
            raise AssertionError(f"position {p} mixes multiplies and linear operations")
        for t, e in enumerate(row):
            if e is not None:
                reads[t].update(x for x in e[2:] if x not in writes[t])
                writes[t].add(e[1])
        if s.sync[p]:
            for t in range(team):
                for u in range(team):
                    if t != u and writes[u] & (reads[t] | writes[t]):
                        raise AssertionError(f"round ending at {p}: threads {t} and {u} race on "
                                             f"{sorted(writes[u] & (reads[t] | writes[t]))}")
            reads = [set() for _ in range(team)]
            writes = [set() for _ in range(team)]
    if not s.sync[-1]:
        raise AssertionError("the step does not end a round")


# -- the header -------------------------------------------------------------------


def header(team: int = TEAM) -> str:
    dbl, add = steps(team)
    words = dbl.words() + add.words()
    lines = [
        "// Generated by cometbft_tpu_torch/ops/bn254_schedule.py (python -m",
        "// cometbft_tpu_torch.ops.bn254_schedule); do not edit. The team schedule of",
        "// bn254.cu: entries [position][team thread], op << 24 | dst << 16 | a << 8 | b,",
        "// bit 31 ends a round (__syncwarp over the team).",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace bn254_schedule {",
        "",
        f"constexpr int kTeam = {team};",
        f"constexpr int kSlots = {max(dbl.slots, add.slots)};",
        f"constexpr int kSlotF = {SLOT_F}, kSlotX = {SLOT_X}, kSlotY = {SLOT_Y}, kSlotZ = {SLOT_Z};",
        f"constexpr int kSlotQ = {SLOT_Q}, kSlotYp = {SLOT_YP}, kSlotYp2 = {SLOT_YP2}, "
        f"kSlotNxp = {SLOT_NXP};",
        f"constexpr uint32_t kNop = {NOP}, kMul = {MUL}, kAdd = {ADD}, kSub = {SUB};",
        f"constexpr int kDblPositions = {len(dbl.entries)}, kAddPositions = {len(add.entries)};",
        f"constexpr int kDblMuls = {dbl.muls}, kAddMuls = {add.muls};",
        "// 6t + 2 below its top bit, walked from bit kAteLen - 1 down to 0",
        f"constexpr int kAteLen = {len(ATE_BITS)};",
        f"constexpr uint64_t kAteBits = 0x{int(''.join(map(str, ATE_BITS)), 2):016x}ull;",
        f"constexpr int kTableWords = {len(words)};",
        "",
        "__device__ const uint32_t kTable[kTableWords] = {",
    ]
    for i in range(0, len(words), team):
        lines.append("    " + ", ".join(f"0x{w:08x}u" for w in words[i : i + team]) + ",")
    lines += ["};", "", "}  // namespace bn254_schedule", ""]
    return "\n".join(lines)


def write_header() -> None:
    HEADER.write_text(header())


# -- the Python model of the team ----------------------------------------------


def _to_mont(x: int) -> int:
    return x * R_MONT % P


def _run(s: Schedule, st: list[int], team: int) -> None:
    """One step on one lane's slots; race-free schedules make in-order
    execution equal to the team's."""
    for row in s.entries:
        for t in range(team):
            e = row[t]
            if e is None:
                continue
            op, d, a, b = e
            if op == MUL:
                st[d] = st[a] * st[b] * R_INV % P
            elif op == ADD:
                st[d] = (st[a] + st[b]) % P
            else:
                st[d] = (st[a] - st[b]) % P


def miller_lane_model(p_pt, q, q1, q2, team: int = TEAM) -> tuple:
    """One lane's Miller value (Fp12 as six (re, im) int pairs) through the
    kernel's tables and slots; coordinates are ints below 2^256."""
    dbl, add = steps(team)
    st = [0] * max(dbl.slots, add.slots)
    xp, yp = (_to_mont(c % P) for c in p_pt)
    st[SLOT_YP], st[SLOT_YP2], st[SLOT_NXP] = yp, 2 * yp % P, -xp % P

    def load_q(pt):
        for j, c in enumerate((pt[0][0], pt[0][1], pt[1][0], pt[1][1])):
            st[SLOT_Q + j] = _to_mont(c % P)

    load_q(q)
    st[SLOT_X : SLOT_X + 4] = st[SLOT_Q : SLOT_Q + 4]
    st[SLOT_Z], st[SLOT_Z + 1] = _to_mont(1), 0
    st[SLOT_F : SLOT_F + 12] = [_to_mont(1)] + [0] * 11
    for bit in ATE_BITS:
        _run(dbl, st, team)
        if bit:
            _run(add, st, team)
    for pt in (q1, q2):
        load_q(pt)
        _run(add, st, team)
    return tuple((st[SLOT_F + 2 * k] * R_INV % P, st[SLOT_F + 2 * k + 1] * R_INV % P)
                 for k in range(6))


def miller_values_model(pairs, team: int = TEAM) -> list:
    """Per-lane Miller values of (G1, G2-affine) pairs through the team
    model, with pi(Q) and -pi^2(Q) as ``bn254_kernel._pack`` makes them."""
    out = []
    for p_pt, q in pairs:
        q1 = _b._g2_frobenius(q)
        q2 = _b._g2_neg(_b._g2_frobenius(q1))
        out.append(miller_lane_model(p_pt, q, q1, q2, team))
    return out


if __name__ == "__main__":
    write_header()
    d, a = steps()
    print(f"{HEADER}: doubling {len(d.entries)} positions, {d.muls} multiplies; addition "
          f"{len(a.entries)} positions, {a.muls} multiplies; {slots()} slots")
