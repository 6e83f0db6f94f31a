"""Coupled-layer (CLAY) MSR regenerating code.

Parity with the reference's ``src/erasure-code/clay/ErasureCodeClay.{h,cc}``
(the FAST'18 "Clay codes" construction): wraps a base MDS code
(scalar_mds, default jerasure reed_sol_van) and couples q*t node layers
pairwise so that single-node repair reads only ``q^{t-1}`` of the
``q^t`` sub-chunks from each of d helpers — repair-bandwidth optimal —
while any <= m erasures remain decodable.

Construction (q = d-k+1, t = (k+m+nu)/q with nu virtual zero chunks
for shortening; sub_chunk_count = q^t):

- nodes live on a q x t grid: chunk i -> (x = i % q, y = i // q);
- sub-chunks are indexed by planes z in [0,q)^t;
- the *uncoupled* symbols U(x,y;z) form, per plane, a codeword of the
  base (q*t - m, m) MDS code;
- the *coupled* (stored) symbols C relate pairwise: for x != z_y,
  with partner node (z_y, y) at partner plane z(y->x),

      C(x,y;z) = U(x,y;z) + g * U(z_y, y; z(y->x))

  (g = alpha, char-2 field, pair matrix [[1,g],[g,1]] invertible since
  det = 1 + g^2 != 0); on the diagonal (x == z_y) C = U.

Decode (and encode, which is just decode with the parity nodes
erased — the reference does the same via ``decode_layered``): process
planes by increasing *intersection score* (count of y whose dot node
(z_y, y) is erased); compute U at surviving nodes (partner known:
2x2 inverse; partner erased: partner plane has lower score and is
already fully U-decoded), then MDS-decode each plane's <= m unknown U
symbols; finally map U back to C at the erased nodes.

Single-node repair reads only planes with z_{y0} = x0, for any
k <= d <= k+m-1 (upstream ErasureCodeClay::parse bounds).  At the
default d = k+m-1 every surviving real node helps; for smaller d the
k+m-1-d aloof survivors are carried as extra MDS erasures and repair
planes are processed by aloof-intersection score, mirroring upstream
repair_one_lost_chunk's order classes.

On the device: the chunks are one ``[n, q^t, sub]`` u8 tensor and U
stays beside it for the whole decode or repair.  A pair transform is
advanced indexing with ``long`` index tensors, GF(2^8) products by a
constant through K7 (``gf_kernels.byte_lut``), and ``torch.where``;
the index tensors are built once per erased set (or per lost node and
aloof set) and cached.  The per-class MDS solve is the base code's
decode (K4) on the same device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import gf
from ..backend import MatrixCodec, to_host
from ..gf_kernels import byte_lut
from ..interface import ErasureCode, ErasureCodeError, Profile

GAMMA = 2  # alpha; any g not in {0, 1} works (det 1 + g^2 != 0)


class _Transform(NamedTuple):
    """Index tensors of one score class's pair transform: U at ``kn``
    x ``P`` from C (and U of lower classes) through each node's partner
    ``(pa, zp)``; ``diag`` marks C = U, ``pe`` an erased partner."""

    kn: torch.Tensor    # [K, 1] nodes
    P: torch.Tensor     # [1, P] planes (or positions in a repair stripe)
    pa: torch.Tensor    # [K, P] partner nodes
    zp: torch.Tensor    # [K, P] partner planes
    diag: torch.Tensor  # [K, P, 1] bool
    pe: torch.Tensor    # [K, P, 1] bool


class ErasureCodeClay(ErasureCode):
    def init(self, profile: Profile) -> None:
        self.profile = profile
        self.k = profile.get_int("k", 4)
        self.m = profile.get_int("m", 2)
        self.d = profile.get_int("d", self.k + self.m - 1)
        if not self.k <= self.d <= self.k + self.m - 1:
            raise ErasureCodeError(
                f"d={self.d} must satisfy k <= d <= k+m-1 "
                f"(k={self.k}, m={self.m}; upstream ErasureCodeClay::parse)"
            )
        self.q = self.d - self.k + 1  # == m only at the default d
        km = self.k + self.m
        self.nu = (self.q - km % self.q) % self.q  # virtual chunks
        self.t = (km + self.nu) // self.q
        self.n = km + self.nu  # grid nodes (incl. virtual)
        self.sub_chunk_no = self.q**self.t
        scalar = profile.get("scalar_mds", "jerasure")
        technique = profile.get("technique", "reed_sol_van")
        if scalar not in ("jerasure", "isa", "jax"):
            raise ErasureCodeError(f"unknown scalar_mds {scalar!r}")
        # base MDS code over all grid nodes: (n - m) data, m parity
        if technique == "reed_sol_van":
            base = gf.vandermonde_matrix(self.n - self.m, self.m)
        elif technique == "cauchy_good":
            base = gf.cauchy_good_matrix(self.n - self.m, self.m)
        else:
            raise ErasureCodeError(f"unknown technique {technique!r}")
        self.base = MatrixCodec(base, "table", device=self.device)
        self._ginv = gf.gf_inv(GAMMA)
        self._det_inv = gf.gf_inv(1 ^ gf.gf_mul(GAMMA, GAMMA))
        mt = gf.mul_table()
        # the three product tables of the pair transforms, on the device
        self._tab_g, self._tab_di, self._tab_gi = (
            torch.from_numpy(np.ascontiguousarray(mt[c])).to(self.device)
            for c in (GAMMA, self._det_inv, self._ginv))
        self._decode_plans: dict = {}
        self._repair_plans: dict = {}

    # ---- geometry ----

    def _xy(self, i: int) -> tuple[int, int]:
        return i % self.q, i // self.q

    def _node(self, x: int, y: int) -> int:
        return y * self.q + x

    def _digit(self, z: int, y: int) -> int:
        return (z // self.q ** (self.t - 1 - y)) % self.q

    def _base_id(self, node: int) -> int:
        """Grid node -> base-code symbol id (data 0..n-m-1, parity after).

        Real data and virtual nodes are base data; real parity chunks
        k..k+m-1 are the base parity symbols.
        """
        if node < self.k:
            return node
        if node >= self.k + self.m:  # virtual
            return self.k + (node - self.k - self.m)
        return (self.n - self.m) + (node - self.k)

    # ---- interface ----

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_alignment(self) -> int:
        return self.k * self.sub_chunk_no * 8

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        size = len(chunks[0])
        if size % self.sub_chunk_no:
            raise ErasureCodeError(
                f"chunk size {size} not divisible by q^t={self.sub_chunk_no}"
            )
        erased = set(range(self.k, self.k + self.m))
        C = self._layout(chunks, size)
        self._decode_layered(C, erased, size // self.sub_chunk_no)
        parity = to_host(C[self.k:self.k + self.m].reshape(self.m, -1))
        for i in range(self.k, self.k + self.m):
            chunks[i][:] = parity[i - self.k]

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        size = len(next(iter(chunks.values())))
        erased = set(range(self.k + self.m)) - set(chunks)
        if len(erased) > self.m:
            raise ErasureCodeError(f"too many erasures: {sorted(erased)}")
        C = self._layout(chunks, size)
        self._decode_layered(C, erased, size // self.sub_chunk_no)
        ids = sorted(want_to_read)
        host = to_host(C[ids].reshape(len(ids), -1))
        return {i: host[pos] for pos, i in enumerate(ids)}

    def _repair_helpers(self, lost: int, available: set[int]) -> set[int] | None:
        """Pick the d helper chunks for single-node repair, or None if
        the repair-optimal path is not possible.

        Every surviving real node in the lost node's grid row must help:
        their stored repair-plane bytes appear irreplaceably in the
        rebuild pair equations (upstream is_repair refuses otherwise and
        falls back to conventional decode).  The rest are filled in node
        order, as upstream minimum_to_repair does.
        """
        if len(available) < self.d:
            return None
        x0, y0 = self._xy(lost)
        real = set(range(self.k + self.m))
        row = ({self._node(x, y0) for x in range(self.q)} & real) - {lost}
        if not row <= available:
            return None
        helpers = set(row)
        for c in sorted(available):
            if len(helpers) == self.d:
                break
            helpers.add(c)
        return helpers if len(helpers) == self.d else None

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        erased = want_to_read - available
        if len(erased) == 1 and len(want_to_read) == 1:
            # repair-optimal single-node path: d helpers.  Upstream
            # is_repair also requires a single *wanted* chunk — with
            # d < k+m-1 the helper set may exclude other wanted chunks,
            # so multi-chunk wants take the conventional minimum.
            helpers = self._repair_helpers(next(iter(erased)), available)
            if helpers is not None:
                return helpers
        return self._minimum_to_decode(want_to_read, available)

    def minimum_to_decode_subchunks(
        self, lost: int, available: set[int]
    ) -> tuple[set[int], list[int]]:
        """Helpers + the plane indices each must supply (the reference's
        sub-chunk-range form of minimum_to_decode)."""
        helpers = self._repair_helpers(lost, available)
        if helpers is None:
            raise ErasureCodeError(
                f"no repair-optimal helper set for {lost} in "
                f"{sorted(available)} (need d={self.d} incl. the lost row)"
            )
        x0, y0 = self._xy(lost)
        planes = [
            z for z in range(self.sub_chunk_no) if self._digit(z, y0) == x0
        ]
        return helpers, planes

    # ---- core machinery ----

    def _layout(self, chunks: dict[int, np.ndarray], size: int) -> torch.Tensor:
        """C[node] = [q^t, sub] on the device; erased nodes zero-filled."""
        sub = size // self.sub_chunk_no
        C = np.zeros((self.n, self.sub_chunk_no, sub), np.uint8)
        for i, buf in chunks.items():
            C[i] = np.asarray(buf, np.uint8).reshape(self.sub_chunk_no, sub)
        return torch.from_numpy(C).to(self.device)

    def _geometry(self):
        """Vectorized plane geometry, computed once per codec instance.

        Returns (digits [Z,t], x [n], y [n], partner [n,Z], zpair [n,Z],
        diag [n,Z], pw [t]) where partner/zpair/diag encode, for every
        (node, plane), the coupled-pair structure the scalar reference
        walks one plane at a time.
        """
        if not hasattr(self, "_geom"):
            q, t, n, Z = self.q, self.t, self.n, self.sub_chunk_no
            pw = q ** (t - 1 - np.arange(t))  # [t]
            z = np.arange(Z)
            digits = (z[:, None] // pw[None, :]) % q  # [Z, t]
            x = np.arange(n) % q
            y = np.arange(n) // q
            zy = digits[:, y].T  # [n, Z] — the node-row digit per plane
            partner = y[:, None] * q + zy  # [n, Z]
            zpair = z[None, :] + (x[:, None] - zy) * pw[y][:, None]  # [n, Z]
            diag = zy == x[:, None]  # [n, Z]
            self._geom = (digits, x, y, partner, zpair, diag, pw)
        return self._geom

    def _dev(self, a) -> torch.Tensor:
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a).to(self.device)

    def _transform_indices(self, kn, P, pa, zp, diag, pe) -> _Transform:
        return _Transform(self._dev(kn[:, None]), self._dev(P[None, :]), self._dev(pa),
                          self._dev(zp), self._dev(diag[..., None]), self._dev(pe[..., None]))

    def _pair_transform(self, C: torch.Tensor, U: torch.Tensor, ix: _Transform) -> torch.Tensor:
        """U at one class's (node, plane) grid: the diagonal keeps C,
        a known partner inverts the pair, an erased partner's U (from a
        lower class) is cancelled out."""
        cn = C[ix.kn, ix.P]  # [K, P, sub]
        cpart = C[ix.pa, ix.zp]
        upa = U[ix.pa, ix.zp]
        u_pair = byte_lut(cn ^ byte_lut(cpart, self._tab_g), self._tab_di)
        u_pe = cn ^ byte_lut(upa, self._tab_g)
        return torch.where(ix.diag, cn, torch.where(ix.pe, u_pe, u_pair))

    def _decode_layered(
        self, C: torch.Tensor, erased: set[int], sub: int
    ) -> None:
        """Recover C at erased nodes in place (<= m erasures).

        Planes are processed in batches by *intersection score*: a
        plane's erased-partner lookups only ever reference planes of
        strictly lower score, so all planes of one score class are
        independent — per class the engine runs one pair transform over
        every surviving node at once and one batched MDS solve over the
        class's plane stripe, versus the reference's per-plane-per-node
        scalar loops (``ErasureCodeClay.cc :: decode_layered``).  The
        index tensors are cached per erased set.
        """
        classes, transforms, rebuild = self._decode_plan(frozenset(erased))
        U = torch.zeros_like(C)
        er = np.zeros(self.n, bool)
        er[list(erased)] = True
        known = np.nonzero(~er)[0].tolist()
        want = {self._base_id(node) for node in erased}
        for P, ix in zip(classes, transforms):
            # 1) U at surviving nodes for the whole class
            U[ix.kn, ix.P] = self._pair_transform(C, U, ix)
            # 2) one batched MDS solve for the whole class
            P_t = ix.P[0]
            avail = {self._base_id(node): U[node, P_t].reshape(-1) for node in known}
            out = self.base.decode_async(avail, want)
            for node in erased:
                U[node, P_t] = out[self._base_id(node)].reshape(len(P), sub)
        # 3) U -> C at erased nodes, all planes at once
        er_t, d_e, pa_e, zp_e = rebuild
        ue = U[er_t]  # [E, Z, sub]
        upz = U[pa_e, zp_e]
        C[er_t] = torch.where(d_e, ue, ue ^ byte_lut(upz, self._tab_g))

    def _decode_plan(self, erased_key: frozenset):
        """Index tensors for decode, cached per erased set: per score
        class the planes and the pair transform's indices, and the final
        U->C rebuild's."""
        if erased_key in self._decode_plans:
            return self._decode_plans[erased_key]
        n = self.n
        digits, _x, _y, partner, zpair, diag, _pw = self._geometry()
        er = np.zeros(n, bool)
        er[list(erased_key)] = True
        node_ids = digits + (np.arange(self.t)[None, :] * self.q)
        score = er[node_ids].sum(axis=1)  # [Z]
        known = np.nonzero(~er)[0]

        classes = []
        transforms = []
        for s in sorted(set(score.tolist())):
            P = np.nonzero(score == s)[0]
            classes.append(P)
            kn = known[:, None]  # [K, 1]
            transforms.append(self._transform_indices(
                known, P, partner[kn, P[None, :]], zpair[kn, P[None, :]],
                diag[kn, P[None, :]], er[partner[kn, P[None, :]]]))

        er_nodes = np.array(sorted(erased_key), np.int64)
        rebuild = (self._dev(er_nodes), self._dev(diag[er_nodes][..., None]),
                   self._dev(partner[er_nodes]), self._dev(zpair[er_nodes]))
        self._decode_plans[erased_key] = (classes, transforms, rebuild)
        return self._decode_plans[erased_key]

    # ---- repair-optimal single-node recovery ----

    def repair(
        self,
        lost: int,
        helper_subchunks: dict[int, dict[int, np.ndarray]],
    ) -> np.ndarray:
        """Recover chunk ``lost`` from d helpers supplying ONLY the
        repair planes (z_{y0} = x0): q^{t-1} sub-chunks each.

        ``helper_subchunks[i][z]`` = helper i's sub-chunk for plane z.
        Returns the full reconstructed chunk (q^t sub-chunks).

        With d < k+m-1 the k+m-1-d non-helping survivors ("aloof"
        nodes, upstream repair_one_lost_chunk) are treated as erasures:
        repair planes are processed in classes of increasing aloof
        intersection score, exactly like _decode_layered, and each
        class's MDS solve carries m unknowns (the q-node lost row plus
        the aloof nodes).
        """
        n = self.n
        x0, y0 = self._xy(lost)
        digits, xv, yv, _partner, _zpair, _diag, _pw = self._geometry()
        planes = np.nonzero(digits[:, y0] == x0)[0]  # [P] repair planes
        npl = len(planes)
        real = set(range(self.k + self.m))
        helpers = set(helper_subchunks)
        if helpers != self._repair_helpers(lost, helpers):
            raise ErasureCodeError(
                f"repair of {lost} needs d={self.d} helpers including "
                f"every survivor in its grid row; got {sorted(helpers)}"
            )
        aloof = real - helpers - {lost}
        sub = len(next(iter(helper_subchunks[next(iter(helpers))].values())))

        # helper sub-chunks on the repair planes; virtual nodes are zero
        Cp = np.zeros((n, npl, sub), np.uint8)
        for i in helpers:
            Cp[i] = np.stack([helper_subchunks[i][int(z)] for z in planes])
        Cp = torch.from_numpy(Cp).to(self.device)

        # unknown nodes: the whole grid row y0 (incl. virtual columns)
        # plus the aloof survivors — m base symbols per plane
        unknown = np.zeros(n, bool)
        unknown[lost] = True
        unknown[(yv == y0) & (xv != x0)] = True
        unknown[list(aloof)] = True
        known = np.nonzero(~unknown)[0].tolist()
        unknown_nodes = np.nonzero(unknown)[0].tolist()
        want = {self._base_id(node) for node in unknown_nodes}

        classes, transforms, rebuild = self._repair_plan(lost, frozenset(aloof))

        U = torch.zeros_like(Cp)
        for P_pos, ix in zip(classes, transforms):
            # U at known nodes for this score class.  A known node's
            # partner shares its row (y != y0), so the pair plane keeps
            # the y0 digit and stays in the repair set; an aloof
            # partner's U comes from a strictly lower class
            U[ix.kn, ix.P] = self._pair_transform(Cp, U, ix)
            # batched MDS solve for the class's plane stripe
            P_t = ix.P[0]
            avail = {self._base_id(node): U[node, P_t].reshape(-1) for node in known}
            solved = self.base.decode_async(avail, want)
            for node in unknown_nodes:
                U[node, P_t] = solved[self._base_id(node)].reshape(len(P_pos), sub)

        # reconstruct the lost chunk over the full plane space
        partner0, pidx, on_diag_idx, diag_mask = rebuild
        u_pz = U[partner0, pidx]  # [Z, sub]
        c_pz = Cp[partner0, pidx]
        # partner's pair equation at plane zpair reveals U(lost, z)
        u_lost = byte_lut(c_pz ^ u_pz, self._tab_gi)
        off_diag = u_lost ^ byte_lut(u_pz, self._tab_g)
        on_diag = U[lost, on_diag_idx]
        out = torch.where(diag_mask, on_diag, off_diag)
        return to_host(out.reshape(-1))

    def _repair_plan(self, lost: int, aloof_key: frozenset):
        """Index tensors for the repair hot path, cached per (lost node,
        aloof set): per score class the stripe positions and the pair
        transform's indices (planes indexed into the repair stripe), and
        the final lost-chunk rebuild [Z, sub] <- (Cp, U)."""
        key = (lost, aloof_key)
        if key in self._repair_plans:
            return self._repair_plans[key]
        n, Z = self.n, self.sub_chunk_no
        x0, y0 = self._xy(lost)
        digits, xv, yv, partner, zpair, diag, pw = self._geometry()
        planes = np.nonzero(digits[:, y0] == x0)[0]
        pos = np.full(Z, -1)
        pos[planes] = np.arange(len(planes))
        unknown = np.zeros(n, bool)
        unknown[lost] = True
        unknown[(yv == y0) & (xv != x0)] = True
        unknown[list(aloof_key)] = True
        known = np.nonzero(~unknown)[0]

        # score: per repair plane, how many rows' plane-digit selects an
        # aloof node (row y0 is never aloof: its survivors must help)
        aloof_mask = np.zeros(n, bool)
        aloof_mask[list(aloof_key)] = True
        node_ids = digits + (np.arange(self.t)[None, :] * self.q)  # [Z, t]
        score = aloof_mask[node_ids].sum(axis=1)[planes]  # [P]

        classes = []
        transforms = []
        for s in sorted(set(score.tolist())):
            P_pos = np.nonzero(score == s)[0]  # positions in the stripe
            classes.append(P_pos)
            zsel = planes[P_pos]  # absolute plane ids
            kn = known[:, None]  # [K, 1]
            transforms.append(self._transform_indices(
                known, P_pos, partner[kn, zsel[None, :]], pos[zpair[kn, zsel[None, :]]],
                diag[kn, zsel[None, :]], aloof_mask[partner[kn, zsel[None, :]]]))

        zy0 = digits[:, y0]
        rebuild = (self._dev(y0 * self.q + zy0),
                   self._dev(pos[np.arange(Z) + (x0 - zy0) * pw[y0]]),
                   self._dev(np.maximum(pos, 0)),
                   self._dev((zy0 == x0)[:, None]))
        self._repair_plans[key] = (classes, transforms, rebuild)
        return self._repair_plans[key]
