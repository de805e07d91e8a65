"""Deterministic INSECURE dev trusted setup for the KZG subsystem.

The port's own copy of `lighthouse_tpu/kzg/trusted_setup.py` (the same
tau, powers, [tau]G2 and window tables for the same size); the GPU
backend packs the tables into kernel words (`kzg/gpu_backend.py`).

A real deployment loads the ceremony output (c-kzg's
trusted_setup.txt — the reference embeds it via the `c-kzg` crate).
Zero-egress testing cannot fetch it, and a ceremony's whole point is
that nobody knows tau — so here tau is DERIVED FROM A FIXED PUBLIC
SECRET and the powers are computed on the fly. Anyone can forge proofs
against this setup; it exists so the verification *data plane* (MSM
commitment, quotient proofs, RLC-folded multi-pairings) is exercised
end to end with hermetic, committed vectors.

Setups are built lazily per polynomial size and cached: the minimal
preset's 4-element blobs cost 4 host scalar muls, while a
mainnet-sized 4096 setup is only ever built if something asks for it.
"""

import hashlib
from dataclasses import dataclass, field

from lighthouse_tpu_torch.crypto.constants import R
from lighthouse_tpu_torch.crypto.ref_curve import G1 as G1_GROUP
from lighthouse_tpu_torch.crypto.ref_curve import G2 as G2_GROUP

# fixed public "secret" — insecure by construction, see module docstring
DEV_SECRET_SEED = b"lighthouse-tpu insecure dev kzg trusted setup"
DEV_TAU = (
    int.from_bytes(hashlib.sha256(DEV_SECRET_SEED).digest(), "big") % R
)


@dataclass(frozen=True)
class TrustedSetup:
    """Powers of tau: [tau^i]G1 for the commitment MSM, [tau]G2 for the
    verification pairing. Points are affine int tuples (reference
    representation); the GPU backend packs them into kernel words at
    marshal time."""

    size: int
    g1_powers: tuple  # affine (x, y) int pairs, length `size`
    tau_g2: tuple  # affine twist point ((x0,x1),(y0,y1))
    # fixed-base MSM digit-multiple tables, keyed (n_points, window c);
    # a mutable cache field, excluded from equality/hash (the frozen
    # dataclass freezes the binding, not the dict)
    _window_tables: dict = field(
        default_factory=dict, compare=False, repr=False
    )
    # dev setups remember tau so derived G2 powers ([tau^m]G2 for the
    # DA cell-multiproof pairing) can be computed on demand; a ceremony
    # setup would ship these points explicitly and leaves this None.
    _dev_tau: int | None = field(default=None, compare=False, repr=False)
    _g2_power_cache: dict = field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def g1_generator(self):
        return self.g1_powers[0]

    def tau_g2_power(self, m: int) -> tuple:
        """[tau^m]G2 as an affine twist point — the second pairing
        input of the coset-folded cell multiproof check (`da.cells`),
        where the vanishing polynomial of a size-m cell coset is
        X^m - c_k. m = 1 is the classic [tau]G2.

        Dev setups derive the point from the known tau; a ceremony
        setup must provide the monomial G2 powers (c-kzg's
        trusted_setup.txt ships 65) — raise loudly rather than guess.
        """
        if m == 1:
            return self.tau_g2
        hit = self._g2_power_cache.get(m)
        if hit is not None:
            return hit
        if self._dev_tau is None:
            raise ValueError(
                f"trusted setup does not carry [tau^{m}]G2 (ceremony "
                "setups must ship monomial G2 powers for DA cells)"
            )
        pt = G2_GROUP.to_affine(
            G2_GROUP.mul_scalar(
                G2_GROUP.generator, pow(self._dev_tau, m, R)
            )
        )
        self._g2_power_cache[m] = pt
        return pt

    def g1_window_table(self, n_points: int, c: int) -> tuple:
        """Digit-multiple table for the device fixed-base MSM
        (`ops.msm.msm_fixed_base`): entry [i][d] is the affine int pair
        of [d] g1_powers[i] for d = 0..2^(c-1) (d = 0 is None, the
        identity — signed digits need only magnitudes; the device table
        holds the negated entries beside them). Built ONCE per (n_points, c) on
        the host and cached on the setup — the setup points are static,
        which is the whole point of the fixed-base path.

        Cost: n_points * (2^(c-1) - 1) group adds, amortized over every
        commitment/proof MSM against this setup.
        """
        if n_points > self.size:
            raise ValueError(
                f"window table wants {n_points} points, setup has "
                f"{self.size}"
            )
        key = (n_points, c)
        hit = self._window_tables.get(key)
        if hit is not None:
            return hit
        b_max = 1 << (c - 1)
        jac = []  # the [2]P..[B]P multiples, Jacobian, point-major
        for aff in self.g1_powers[:n_points]:
            base = G1_GROUP.from_affine(aff)
            acc = base
            for _ in range(b_max - 1):
                acc = G1_GROUP.add(acc, base)
                jac.append(acc)
        affs = _batch_to_affine_g1(jac)  # ONE field inversion total
        table = tuple(
            (None, self.g1_powers[i])
            + tuple(affs[i * (b_max - 1) : (i + 1) * (b_max - 1)])
            for i in range(n_points)
        )
        self._window_tables[key] = table
        return table


def _batch_to_affine_g1(points) -> list:
    """Jacobian G1 points -> affine int pairs (None = infinity), ONE
    Fp inversion total via Montgomery's simultaneous-inversion trick
    (the G2 twin is the to-affine kernel's Jacobian entry,
    ops/curve_kernels.jacobian_to_affine)."""
    F = G1_GROUP.F
    zs, keep = [], []
    for i, pt in enumerate(points):
        if not G1_GROUP.is_infinity(pt):
            zs.append(pt[2])
            keep.append(i)
    out = [None] * len(points)
    if not zs:
        return out
    prefix = [zs[0]]
    for z in zs[1:]:
        prefix.append(F.mul(prefix[-1], z))
    acc = F.inv(prefix[-1])
    invs = [None] * len(zs)
    for j in range(len(zs) - 1, 0, -1):
        invs[j] = F.mul(acc, prefix[j - 1])
        acc = F.mul(acc, zs[j])
    invs[0] = acc
    for j, i in enumerate(keep):
        x, y, _ = points[i]
        zi2 = F.sqr(invs[j])
        out[i] = (F.mul(x, zi2), F.mul(y, F.mul(zi2, invs[j])))
    return out


def g1_generator_multiples(n: int) -> list:
    """[1]G .. [n]G as affine int pairs — one Jacobian add chain plus
    one simultaneous inversion. The shared source of cheap distinct G1
    points (no decompression, no setup build) for the committed MSM
    vectors and the MSM test fixtures: one implementation, so they
    cannot silently desynchronize."""
    base = G1_GROUP.generator
    acc = base
    jac = []
    for _ in range(n):
        jac.append(acc)
        acc = G1_GROUP.add(acc, base)
    return _batch_to_affine_g1(jac)


_CACHE: dict[int, TrustedSetup] = {}


def dev_setup(size: int, tau: int = DEV_TAU) -> TrustedSetup:
    """Build (and cache) the size-`size` dev setup. Successive powers
    are one scalar mul each: P_{i} = [tau]P_{i-1}."""
    if size < 1:
        raise ValueError("trusted setup needs at least one G1 power")
    key = size if tau == DEV_TAU else -1
    hit = _CACHE.get(key)
    if hit is not None and hit.size == size:
        return hit
    powers = [G1_GROUP.generator]
    for _ in range(size - 1):
        powers.append(G1_GROUP.mul_scalar(powers[-1], tau))
    setup = TrustedSetup(
        size=size,
        g1_powers=tuple(
            G1_GROUP.to_affine(p) for p in powers
        ),
        tau_g2=G2_GROUP.to_affine(
            G2_GROUP.mul_scalar(G2_GROUP.generator, tau)
        ),
        _dev_tau=tau,
    )
    if tau == DEV_TAU:
        _CACHE[size] = setup
    return setup
