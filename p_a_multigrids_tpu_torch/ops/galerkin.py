"""Galerkin coarse operator: A_coarse = P^T A_fine P on the block stencil.

Numpy copy of the JAX package's ``ops/galerkin.py``; it yields the same
blocks bit for bit (``tests/test_torch_galerkin.py``).

The coarse operator is the variational triple product with the
prolongation P of ``models.semi._transfer_tables``.  P is macro-local and A
couples only face neighbors, so the coarse sparsity is exactly the fine
pattern (self + 3 faces + boundary-strip cross blocks), and the product
reduces to accumulating 3x3 congruence transforms pw^T B pw over the fine
stencil: a setup-time contraction with no dynamic sparsity.

For scale-invariant physics (surface_terms=False: mass + volume
diffusion/advection on nested P1 spaces) the Galerkin and geometric coarse
operators coincide; with SIP surface terms they differ, and Galerkin is the
variationally consistent choice.
"""

from __future__ import annotations

import numpy as np

from ..mesh import splitting
from .stencil import StencilData


def galerkin_coarse(fine: StencilData, n_coarse: int,
                    coarse_geometric: StencilData) -> StencilData:
    """P^T A P of a fine-level stencil -> coarse-level StencilData.

    Args:
      fine: stencil blocks at split depth n_coarse + 1
      n_coarse: coarse split depth
      coarse_geometric: the geometrically assembled coarse stencil; its
        static index sets (halo_src, slots, onehots) define the coarse
        layout and validate the product's sparsity; only its numeric
        blocks are replaced.
    """
    from ..models.semi import _transfer_tables

    _, parent, pw = _transfer_tables(n_coarse)           # pw (Cf, 3, 3)
    Cf = 4 ** (n_coarse + 1)
    Cc = 4 ** n_coarse
    U = fine.self_blocks.shape[0]
    cn_f = splitting.child_neighbors(n_coarse + 1)
    cn_c = splitting.child_neighbors(n_coarse)

    slot_c = {}
    for s, (c, f) in enumerate(zip(coarse_geometric.bnd_c,
                                   coarse_geometric.bnd_f)):
        slot_c[(int(c), int(f))] = s
    nb_c = len(coarse_geometric.bnd_c)

    Sc = np.zeros((U, Cc, 3, 3), fine.self_blocks.dtype)
    Fc = np.zeros((U, Cc, 3, 3, 3), fine.self_blocks.dtype)
    Xc = np.zeros((U, nb_c, 3, 3), fine.self_blocks.dtype)

    def congr(pl, B, pr):
        # (3,3)^T @ (U,3,3) @ (3,3), batched over U
        return np.einsum("li,ulm,mk->uik", pl, B, pr, optimize=True)

    # self + intra-macro couplings
    for fc in range(Cf):
        cc = int(parent[fc])
        Sc[:, cc] += congr(pw[fc], fine.self_blocks[:, fc], pw[fc])
        for f in range(3):
            fc2 = int(cn_f[fc, f])
            if fc2 < 0:
                continue
            cc2 = int(parent[fc2])
            blk = congr(pw[fc], fine.face_blocks[:, fc, f], pw[fc2])
            if cc2 == cc:
                Sc[:, cc] += blk
            else:
                fcs = np.nonzero(cn_c[cc] == cc2)[0]
                if len(fcs) != 1:
                    raise ValueError("fine coupling escaped the coarse "
                                     "stencil pattern")
                Fc[:, cc, int(fcs[0])] += blk

    # cross-macro strip couplings
    halo_ok = np.ones(nb_c, bool)
    for slot, (fc, f) in enumerate(zip(fine.bnd_c, fine.bnd_f)):
        cc = int(parent[fc])
        sc = slot_c[(cc, int(f))]
        src = fine.halo_src[:, slot]                     # (U,) v*Cf + src_c
        v, src_c = src // Cf, src % Cf
        psrc = parent[src_c]                             # (U,)
        # coarse sparsity check: the product lands exactly on the coarse
        # level's own halo slots
        want = v * Cc + psrc
        interior = np.abs(fine.cross_blocks[:, slot]).max(axis=(1, 2)) > 0
        ok = ~interior | (coarse_geometric.halo_src[:, sc] == want)
        halo_ok[sc] &= bool(ok.all())
        pws = pw[src_c]                                  # (U, 3, 3)
        Xc[:, sc] += np.einsum("li,ulm,umk->uik", pw[fc],
                               fine.cross_blocks[:, slot], pws,
                               optimize=True)
    if not halo_ok.all():
        raise ValueError("Galerkin cross blocks escaped the coarse halo "
                         "pattern")

    # the affine Dirichlet-ghost vector only matters on the finest level
    # (coarse correction equations are homogeneous); restrict it anyway so
    # apply(with_bc=True) stays meaningful: c_c = P^T c_f
    c_aff = np.zeros((U, Cc, 3), fine.c_aff.dtype)
    np.add.at(c_aff, (slice(None), parent),
              np.einsum("fli,ufl->ufi", pw, fine.c_aff, optimize=True))

    return StencilData(
        self_blocks=Sc, face_blocks=Fc, cross_blocks=Xc, c_aff=c_aff,
        halo_src=coarse_geometric.halo_src, bnd_c=coarse_geometric.bnd_c,
        bnd_f=coarse_geometric.bnd_f,
        intra_onehot=coarse_geometric.intra_onehot,
        cross_onehot=coarse_geometric.cross_onehot)
