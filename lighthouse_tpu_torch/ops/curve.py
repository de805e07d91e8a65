"""Plain complete projective G1/G2 arithmetic on batch-last bundles.

The Renes-Costello-Batina complete formulas for y^2 = x^3 + b (a = 0),
Algorithms 7 and 9, exactly as the JAX package stages them
(`lighthouse_tpu/ops/curve.py` `ProjectiveGroup` builds the matrices,
`ops/tcurve.py` `TProjective` runs them on batch-last bundles): each stage
runs its independent field products as ONE stacked multiply and its linear
recombination as ONE combination. A point is (X, Y, Z), each coordinate
(w, NB, B) with w = 1 (G1, Fp) or 2 (G2, Fp2); the identity is (0 : 1 : 0).
Completeness holds on the odd-order r-torsion, which is all the verify path
feeds in.

These are the plain versions behind K1 (`ops/ladder.py`) and the helper
kernels (`lane_sum`, `to_affine`, `jacobian_to_affine`, in
`ops/curve_kernels.py`).

`Jacobian` is the JAX package's unified Jacobian group
(`lighthouse_tpu/ops/curve.py` `JacobianGroup`): dbl-2001-b and the
generic addition with its selects for p == q, p == -q and the point at
infinity (Z = 0), layer by layer as the JAX package stacks its products,
so one step gives the same canonical words. It is total on any point of
the curve, of any order, which the RCB formulas are not: the plain
version behind the subgroup check (`ops/subgroup.py`), whose inputs are
unchecked points.
"""

import numpy as np
import torch

from lighthouse_tpu_torch.ops import field as fd
from lighthouse_tpu_torch.ops.programs import FP2_MUL

NB = fd.NB


class _Group:
    """What both coordinate systems share: the width w of a coordinate
    (1: Fp, 2: Fp2), stacked products and per-lane selects."""

    def __init__(self, w: int):
        self.w = w

    def _mul(self, a, b):
        if self.w == 1:
            return fd.mul_lazy(a, b)
        return fd.bilinear(a, b, FP2_MUL)

    def _stack_mul(self, avals, bvals):
        out = self._mul(torch.stack(avals), torch.stack(bvals))
        return list(out.unbind(0))

    def select(self, cond, a, b):
        return tuple(fd.select(cond, ca, cb) for ca, cb in zip(a, b))

    def neg(self, pt):
        return (pt[0], fd.apply_combo(pt[1], -np.eye(self.w, dtype=np.int32)), pt[2])

    @staticmethod
    def _is_zero(Z):
        return (fd.canon(Z) == 0).all(dim=-2).all(dim=-2)


class Projective(_Group):
    """Complete projective group over Fp (w = 1) or Fp2 (w = 2); `b3` is the
    component-space matrix of multiplication by 3b."""

    def __init__(self, w: int, b3):
        super().__init__(w)
        b3 = np.asarray(b3, dtype=np.int64)
        Iw = np.eye(w, dtype=np.int64)

        def kron(m):
            return np.kron(np.asarray(m, np.int64), Iw).astype(np.int32)

        def rows(spec, n_in):
            m = np.zeros((len(spec) * w, n_in * w), np.int64)
            for r, row in enumerate(spec):
                for idx, coeff, use_b3 in row:
                    blk = coeff * (b3 if use_b3 else Iw)
                    m[r * w : (r + 1) * w, idx * w : (idx + 1) * w] += blk
            return m.astype(np.int32)

        # add stage 1 operands over [X, Y, Z]: X; Y; Z; X+Y; Y+Z; X+Z
        self.ADD_OPS = kron(
            [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1]]
        )
        # over m = [X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
        # (X1+Z1)(X2+Z2)]: t3, t4, t5, T0 = 3 m0, Z3s = m1 + b3 m2,
        # t1m = m1 - b3 m2
        self.ADD_C1 = rows(
            [
                [(3, 1, False), (0, -1, False), (1, -1, False)],
                [(4, 1, False), (1, -1, False), (2, -1, False)],
                [(5, 1, False), (0, -1, False), (2, -1, False)],
                [(0, 3, False)],
                [(1, 1, False), (2, 1, True)],
                [(1, 1, False), (2, -1, True)],
            ],
            6,
        )
        self.B3_ROW = rows([[(0, 1, True)]], 1)  # y3c = b3 t5
        # over [X3a, t2x, Y3a, t1z, t0t, Z3a]
        self.ADD_C3 = rows(
            [
                [(1, 1, False), (0, -1, False)],
                [(3, 1, False), (2, 1, False)],
                [(5, 1, False), (4, 1, False)],
            ],
            6,
        )
        # double over [YY, YZ, ZZ, XY]: Z8 = 8 m0; t2v = b3 m2; Y3s = m0 + b3 m2
        self.DBL_C1 = rows(
            [[(0, 8, False)], [(2, 1, True)], [(0, 1, False), (2, 1, True)]], 4
        )
        self.DBL_C2 = kron([[1, -3]])  # t0f = m0 - 3 t2v
        # over [X3m, Z3f, Y3f, X3h]: X3 = 2 X3h; Y3 = X3m + Y3f; Z3 = Z3f
        self.DBL_C3 = kron([[0, 0, 0, 2], [1, 0, 1, 0], [0, 1, 0, 0]])

    # ---------------------------------------------------------- helpers

    def _combo(self, vals, m, n_out):
        w = self.w
        y = fd.apply_combo(torch.cat(vals, dim=-3), m)
        return [y[..., w * i : w * (i + 1), :, :] for i in range(n_out)]

    def identity(self, batch: int, device):
        zero = torch.zeros((self.w, NB, batch), dtype=torch.int32, device=device)
        return (zero, fd.one_slot0(self.w, batch, device), zero.clone())

    def from_affine(self, aff, valid):
        """(x, y) (w, NB, B) + (B,) mask -> projective; invalid lanes become
        the identity (0 : 1 : 0)."""
        x, y = aff
        ix, iy, iz = self.identity(x.shape[-1], x.device)
        one = fd.one_slot0(self.w, x.shape[-1], x.device)
        return (
            fd.select(valid, x, ix),
            fd.select(valid, y, iy),
            fd.select(valid, one, iz),
        )

    # -------------------------------------------------------- group ops

    def add(self, p, q):
        """RCB Algorithm 7."""
        a_ops = self._combo(list(p), self.ADD_OPS, 6)
        b_ops = self._combo(list(q), self.ADD_OPS, 6)
        m = self._stack_mul(a_ops, b_ops)
        t3, t4, t5, T0, Z3s, t1m = self._combo(m, self.ADD_C1, 6)
        (y3c,) = self._combo([t5], self.B3_ROW, 1)
        prods = self._stack_mul(
            [t4, t3, y3c, t1m, T0, Z3s], [y3c, t1m, T0, Z3s, t3, t4]
        )
        x3, y3, z3 = self._combo(prods, self.ADD_C3, 3)
        return (x3, y3, z3)

    def double(self, pt):
        """RCB Algorithm 9."""
        X, Y, Z = pt
        m0, m1, m2, m3 = self._stack_mul([Y, Y, Z, X], [Y, Z, Z, Y])
        z8, t2v, y3s = self._combo([m0, m1, m2, m3], self.DBL_C1, 3)
        (t0f,) = self._combo([m0, t2v], self.DBL_C2, 1)
        prods = self._stack_mul([t2v, m1, t0f, t0f], [z8, z8, y3s, m3])
        x3, y3, z3 = self._combo(prods, self.DBL_C3, 3)
        return (x3, y3, z3)

    # ------------------------------------- the chain and the 2-bit window

    def ladder_step(self, acc, addend, bit):
        """One double-add step: acc += addend where bit == 1, the addend
        doubles (tcurve.ladder_step). bit (B,) int."""
        acc = self.select(bit == 1, self.add(acc, addend), acc)
        return acc, self.double(addend)

    def window2_table(self, pt):
        """{identity, P, 2P, 3P} (tcurve.window2_table)."""
        p2 = self.double(pt)
        return (self.identity(pt[0].shape[-1], pt[0].device), pt, p2, self.add(p2, pt))

    def window2_step(self, acc, table, digit):
        """acc <- 4 acc + table[digit], digit (B,) in 0..3: two doublings,
        the select tree of tcurve.window2_step, one complete addition (digit
        0 adds the identity entry, no branch)."""
        acc = self.double(self.double(acc))
        t01 = self.select(digit == 1, table[1], table[0])
        t23 = self.select(digit == 3, table[3], table[2])
        return self.add(acc, self.select(digit >= 2, t23, t01))

    # ------------------------------------------- signed-digit windows

    def window_table(self, pt, c: int):
        """[identity, P, 2P, .., 2^(c-1) P]: even entries by doubling, odd
        by one addition."""
        table = [self.identity(pt[0].shape[-1], pt[0].device), pt]
        for d in range(2, (1 << (c - 1)) + 1):
            table.append(
                self.double(table[d // 2]) if d % 2 == 0 else self.add(table[-1], pt)
            )
        return tuple(table)

    def window_step(self, acc, table, mag, neg, c: int):
        """acc <- [2^c] acc + sign * table[mag]: c doublings, a select chain
        over the table, one complete addition. mag (B,) int, neg (B,) bool."""
        for _ in range(c):
            acc = self.double(acc)
        t = table[0]
        for d in range(1, len(table)):
            t = self.select(mag == d, table[d], t)
        t = self.select(neg, self.neg(t), t)
        return self.add(acc, t)

    # -------------------------------------------------------- reductions

    def sum_lanes(self, pt, seg: int):
        """Sum each run of `seg` consecutive lanes (a power of two) to one
        point: repeated halving, lane j + seg/2 added to lane j
        (tcurve.sum_lanes, segmented)."""
        assert seg & (seg - 1) == 0, "sum_lanes needs a power-of-two segment"
        x = pt
        while seg > 1:
            half = seg // 2
            lead = x[0].shape[:-1]
            parts = [c.reshape(*lead, -1, seg) for c in x]
            a = tuple(c[..., :half].reshape(*lead, -1) for c in parts)
            b = tuple(c[..., half:].reshape(*lead, -1) for c in parts)
            x = self.add(a, b)
            seg = half
        return x

    def _inv(self, Z):
        """1 / Z per lane (Fp2: conj(Z) / (Z0^2 + Z1^2)); inv(0) == 0."""
        if self.w == 1:
            return fd.inv(Z)
        sq = fd.sqr_lazy(Z)
        ninv = fd.inv(fd.add(sq[0:1], sq[1:2]))
        conj = fd.apply_combo(Z, np.array([[1, 0], [0, -1]], np.int32))
        return fd.mul_lazy(conj, torch.broadcast_to(ninv, conj.shape))

    def to_affine(self, pt):
        """(x, y, is_identity) with x = X/Z, y = Y/Z; the identity maps to
        (0, 0), since inv(0) == 0."""
        X, Y, Z = pt
        zinv = self._inv(Z)
        x, y = self._stack_mul([X, Y], [zinv, zinv])
        return x, y, self._is_zero(Z)

    def jacobian_to_affine(self, pt):
        """Jacobian (X, Y, Z) in the plain domain (not Montgomery), values
        below p -> (x, y, is_identity) in Montgomery form with x = X/Z^2,
        y = Y/Z^3 (crypto/ref_curve's coordinates); Z = 0 maps to (0, 0)."""
        X, Y, Z = (fd.to_mont(c) for c in pt)
        zinv = self._inv(Z)
        zi2 = self._mul(zinv, zinv)
        x, y = self._stack_mul([X, Y], [zi2, self._mul(zi2, zinv)])
        return x, y, self._is_zero(Z)


class Jacobian(_Group):
    """The unified Jacobian group over Fp (w = 1) or Fp2 (w = 2), the port
    of `JacobianGroup`: (X, Y, Z) is the point (X / Z^2, Y / Z^3), Z = 0 the
    point at infinity."""

    def infinity_like(self, pt):
        """(1, 1, 0) on the lanes of `pt`."""
        one = fd.one_slot0(self.w, pt[0].shape[-1], pt[0].device)
        return (one, one.clone(), torch.zeros_like(one))

    def from_affine(self, x, y, valid):
        """(x, y) (w, NB, B) + (B,) mask -> (x, y, 1); invalid lanes become
        (0, 1, 0), the point at infinity (batch_verify.g2_points_in_subgroup)."""
        one = fd.one_slot0(self.w, x.shape[-1], x.device)
        zero = torch.zeros_like(x)
        return (fd.select(valid, x, zero), fd.select(valid, y, one), fd.select(valid, one, zero))

    def is_infinity(self, pt):
        return self._is_zero(pt[2])

    def double(self, pt):
        """dbl-2001-b: total, a Z = 0 or Y = 0 input gives Z3 = 0."""
        x, y, z = pt
        a, b, yz = self._stack_mul([x, y, y], [x, y, z])
        e = fd.scalar_small(a, 3)
        xb = fd.add(x, b)
        c, xb2, f = self._stack_mul([b, xb, e], [b, xb, e])
        d = fd.scalar_small(fd.sub(fd.sub(xb2, a), c), 2)
        x3 = fd.sub(f, fd.scalar_small(d, 2))
        (t,) = self._stack_mul([e], [fd.sub(d, x3)])
        y3 = fd.sub(t, fd.scalar_small(c, 8))
        return (x3, y3, fd.scalar_small(yz, 2))

    def add(self, p, q):
        """The generic addition, then the selects: p == q (H = 0, R = 0,
        neither at infinity) takes the doubling, Z(q) = 0 gives p and Z(p) =
        0 gives q. p == -q needs no select: the generic Z3 = 2 Z1 Z2 H is 0."""
        x1, y1, z1 = p
        x2, y2, z2 = q
        inf_p, inf_q = self.is_infinity(p), self.is_infinity(q)
        z1s, z2s = self._stack_mul([z1, z2], [z1, z2])
        u1, u2, z2c, z1c = self._stack_mul([x1, x2, z2s, z1s], [z2s, z1s, z2, z1])
        s1, s2 = self._stack_mul([y1, y2], [z2c, z1c])
        h = fd.sub(u2, u1)
        r = fd.sub(s2, s1)
        same_x, same_y = self._is_zero(h), self._is_zero(r)
        h2 = fd.scalar_small(h, 2)
        rr = fd.scalar_small(r, 2)
        (zz,) = self._stack_mul([z1], [z2])
        i, rr2, zzh = self._stack_mul([h2, rr, zz], [h2, rr, h])
        z3 = fd.scalar_small(zzh, 2)
        j, v = self._stack_mul([h, u1], [i, i])
        x3 = fd.sub(fd.sub(rr2, j), fd.scalar_small(v, 2))
        t, s1j = self._stack_mul([rr, s1], [fd.sub(v, x3), j])
        y3 = fd.sub(t, fd.scalar_small(s1j, 2))
        use_dbl = ~inf_p & ~inf_q & same_x & same_y
        out = (x3, y3, z3)
        if bool(use_dbl.any()):  # the doubling only where a lane takes it: equal words
            out = self.select(use_dbl, self.double(p), out)
        out = self.select(inf_q, p, out)
        return self.select(inf_p, q, out)


# b3 = 3b: G1 b = 4 -> 12; G2 b = 4 + 4u -> 12 + 12u, acting on (a0 + a1 u)
# as (12 a0 - 12 a1) + (12 a0 + 12 a1) u
G1 = Projective(1, [[12]])
G2 = Projective(2, [[12, -12], [12, 12]])


# the unified Jacobian G2, the subgroup check's group
J2 = Jacobian(2)


def group(w: int) -> Projective:
    return G1 if w == 1 else G2
