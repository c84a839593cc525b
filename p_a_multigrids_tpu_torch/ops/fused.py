"""Layout conversion between the standard (U, C, 3) state and the
transposed (3, C, U) layout the solver runs in, and the transposed-layout
term-by-term operator of the non-stencil path (from the JAX package's
``ops/fused.py``).

``FusedOperator`` applies A = M/dt + theta*L of one level to a (3, C, U)
state without a block stencil: the volume terms are 3x3 products over
(C, U) planes, the intra-macro neighbor exchange is a static row gather
from the (3C, U) plane, and only the 3*2**s cross-macro strip values a
macro use per-macro gathers, whose indices are built once as int64 device
tensors.  It is the operator of the n_split >= 7 levels (C = 16,384 and
more), where the JAX package builds no stencil; on the TPU it ran as XLA,
not as a Pallas kernel, and here it is plain PyTorch on any device.
``FusedOperator.apply`` equals ``models.semi.apply_A`` to float rounding.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Physics
from ..mesh import splitting


def to_t(T: torch.Tensor) -> torch.Tensor:
    """(U, C, n) -> (n, C, U), contiguous."""
    return T.permute(2, 1, 0).contiguous()


def from_t(Tt: torch.Tensor) -> torch.Tensor:
    """(n, C, U) -> (U, C, n), contiguous."""
    return Tt.permute(2, 1, 0).contiguous()


class FusedOperator(nn.Module):
    """A = M/dt + theta*L at one level, in the transposed layout, from the
    level's host tables (``models.semi.build_problem``, in the run dtype).

    Buffers (the run dtype, index tables int64, on ``device``, the card
    unless the caller asks for the CPU):
      vol_const (3, 3, U) M/dt + theta*D;  vol_K (3, 3, U) theta*K
      ud_c (1, C, 1) the children's up/down sign
      intra_rows (3f, 2, C)  flat (node*C + child) row of my k-th face
                             node's neighbor value inside the macro
      halo_idx (U, nb)       flat (c*U + u) source of each strip slot
      halo_perm (2, nb, U)   neighbor node at my k-th face node of a slot
      slot_of (3f, C)        strip slot of (face, child) on the macro edge
      bc_strip, neu_strip, interior_strip, own_rows: the strip's Dirichlet
      ghosts, no-flux mask, interior mask and own-trace rows
      sdet (3f, sngi, U), snorm (3f, sngi, 2, U), and the diffusive face
      coefficients pen_coef, cons_coef, sym_coef (3f, C, U), nx1 (2, 3, U)
    """

    def __init__(self, L: dict, phys: Physics, dt: float, theta: float,
                 device="cuda"):
        super().__init__()
        self.phys = phys
        self.theta = theta
        U = int(L["M"].shape[0])
        C = int(L["updown"].shape[0])
        s = int(L["s"])
        np_dtype = np.asarray(L["M"]).dtype
        self.U, self.C, self.s = U, C, s
        np_ = np.asarray
        ud = np_(L["updown"]).astype(np.float64)          # (C,)

        def buf(name, a, dtype=np_dtype):
            self.register_buffer(name, torch.tensor(
                np.ascontiguousarray(np.asarray(a, dtype)), device=device))

        # volume blocks: M/dt + theta*D and theta*K as (3, 3, U) planes
        M = np_(L["M"]).transpose(1, 2, 0) / dt
        vol = M + (theta * np_(L["D"]).transpose(1, 2, 0)
                   if phys.diffusion else 0.0)
        buf("vol_const", vol)
        self.register_buffer("vol_K", None)
        if phys.advection:
            buf("vol_K", theta * np_(L["K"]).transpose(1, 2, 0))
        buf("ud_c", ud[None, :, None])

        self.surface = phys.surface_terms
        if not self.surface:
            return

        nface, sngi = 3, int(np_(L["sn"]).shape[0])
        self.sngi = sngi
        # static shape-function tables as plain floats
        self.fsn = np_(L["face_sn"]).astype(np.float64).tolist()  # [f][g][i]
        self.sn1 = np_(L["sn"]).astype(np.float64).tolist()       # [g][k]

        cn = splitting.child_neighbors(s)                 # (C, 3)
        perm_in = splitting.child_neighbor_nodeperm(s)    # (C, 3, 2)
        intra_rows = np.zeros((nface, 2, C), np.int64)
        for f in range(nface):
            for k in range(2):
                nb = np.where(cn[:, f] >= 0, cn[:, f], np.arange(C))
                node = np.where(cn[:, f] >= 0, perm_in[:, f, k], 0)
                intra_rows[f, k] = node * C + nb
        buf("intra_rows", intra_rows, np.int64)
        buf("intra_mask", (cn >= 0).T[:, :, None], bool)  # (3f, C, 1)
        buf("grad_rows", np.where(cn >= 0, cn, np.arange(C)[:, None]).T,
            np.int64)

        bnd_c, bnd_f = np.nonzero(cn < 0)
        nbs = len(bnd_c)
        self.nb = nbs
        buf("bnd_c", bnd_c, np.int64)
        slot_of = np.zeros((nface, C), np.int64)
        slot_of[bnd_f, bnd_c] = np.arange(nbs)
        buf("slot_of", slot_of, np.int64)
        neigh = np_(L["neigh_elem"])
        hsrc = neigh[:, bnd_c, bnd_f]                     # (U, nb)
        self_flat = np.arange(U)[:, None] * C + bnd_c[None, :]
        hsrc_safe = np.where(hsrc >= 0, hsrc, self_flat)
        buf("halo_idx", (hsrc_safe % C) * U + hsrc_safe // C, np.int64)
        buf("halo_perm", np_(L["neigh_perm"])[:, bnd_c, bnd_f]
            .transpose(2, 1, 0), np.int64)                # (2, nb, U)
        buf("interior_strip", (hsrc >= 0).T[None], bool)  # (1, nb, U)
        buf("bc_strip", np_(L["bc_dense"])[:, bnd_c, bnd_f]
            .transpose(2, 1, 0))                          # (2, nb, U)
        buf("neu_strip", np_(L["neu_mask"])[:, bnd_c, bnd_f].T[None], bool)
        # own-trace rows for the Neumann mirror: my face node k of each slot
        fn = splitting.CHILD_FACE_NODES
        buf("own_rows", np.stack([np_(fn)[bnd_f, k] * C + bnd_c
                                  for k in range(2)]), np.int64)  # (2, nb)
        buf("sdet", np_(L["sdet"]).transpose(1, 2, 0))    # (3f, sngi, U)
        buf("snorm", np_(L["snorm"]).transpose(1, 2, 3, 0))  # (3f, sngi, 2, U)

        if phys.diffusion:
            k = phys.k
            pen = (theta * phys.penalty_factor * k
                   * np_(L["inv_dx"]) * np_(L["diff_on"]))
            buf("pen_coef", pen.transpose(2, 1, 0))
            # theta*k*diff_on (consistency) and theta*k*w'*diff_on (symmetry)
            don = np_(L["diff_on"]).transpose(2, 1, 0)    # (3f, C, U)
            buf("cons_coef", theta * k * don)
            bnd_t = (neigh < 0).transpose(2, 1, 0)
            buf("sym_coef", theta * k * np.where(bnd_t, 1.0, 0.5) * don)
        if phys.sip_consistency and phys.diffusion:
            buf("nx1", np_(L["nx1"]).transpose(1, 2, 0) * (2.0 ** s))

    # -- neighbor values -----------------------------------------------------
    def _neighbor_nodes(self, Tt, with_bc: bool):
        """T2[f][k] (C, U): the neighbor's value at my k-th face node of
        face f (Dirichlet ghosts or zero on the domain boundary, my own
        trace on a no-flux face)."""
        n, C, U = Tt.shape
        plane = Tt.reshape(n * C, U)
        plane_cu = Tt.reshape(n, C * U)
        halo = plane_cu[:, self.halo_idx].transpose(1, 2)     # (3, nb, U)
        h = [torch.gather(halo, 0, self.halo_perm[k][None])[0]
             for k in range(2)]
        bc = (self.bc_strip if with_bc
              else torch.zeros_like(self.bc_strip))           # (2, nb, U)
        own = plane[self.own_rows]                            # (2, nb, U)
        bc = torch.where(self.neu_strip, own, bc)
        strip = [torch.where(self.interior_strip[0], h[k], bc[k])
                 for k in range(2)]                           # each (nb, U)
        out = []
        for f in range(3):
            vals = []
            for k in range(2):
                intra = plane[self.intra_rows[f, k]]          # (C, U)
                cross = strip[k][self.slot_of[f]]             # (C, U)
                vals.append(torch.where(self.intra_mask[f], intra, cross))
            out.append(vals)
        return out

    def _neighbor_grad(self, G):
        """G2[f] (2, C, U): the neighbor's P1 gradient across face f."""
        _, C, U = G.shape
        plane_cu = G.reshape(2, C * U)
        ghalo = plane_cu[:, self.halo_idx].transpose(1, 2)    # (2, nb, U)
        gown = G[:, self.bnd_c, :]                            # (2, nb, U)
        gstrip = torch.where(self.interior_strip, ghalo, gown)
        out = []
        for f in range(3):
            gin = G[:, self.grad_rows[f], :]                  # (2, C, U)
            gcr = gstrip[:, self.slot_of[f], :]
            out.append(torch.where(self.intra_mask[f][None], gin, gcr))
        return out

    # -- application ---------------------------------------------------------
    def apply(self, Tt: torch.Tensor, with_bc: bool) -> torch.Tensor:
        """A Tt (+ the Dirichlet ghost terms when with_bc), (3, C, U)."""
        phys = self.phys
        theta = self.theta
        ud = self.ud_c[0]                                     # (C, 1)
        out = []
        for i in range(3):
            acc = self.vol_const[i, 0][None] * Tt[0]
            for j in range(1, 3):
                acc = acc + self.vol_const[i, j][None] * Tt[j]
            if self.vol_K is not None:
                kacc = self.vol_K[i, 0][None] * Tt[0]
                for j in range(1, 3):
                    kacc = kacc + self.vol_K[i, j][None] * Tt[j]
                acc = acc - ud * kacc
            out.append(acc)
        if not self.surface:
            return torch.stack(out)

        T2 = self._neighbor_nodes(Tt, with_bc)
        sip = phys.sip_consistency and phys.diffusion
        if sip:
            G = torch.stack([
                ud * (self.nx1[d, 0][None] * Tt[0]
                      + self.nx1[d, 1][None] * Tt[1]
                      + self.nx1[d, 2][None] * Tt[2])
                for d in range(2)])                           # (2, C, U)
            G2 = self._neighbor_grad(G)

        for f in range(3):
            for g in range(self.sngi):
                w0, w1, w2 = self.fsn[f][g]
                t_sgi = w0 * Tt[0] + w1 * Tt[1] + w2 * Tt[2]
                t2_sgi = (self.sn1[g][0] * T2[f][0]
                          + self.sn1[g][1] * T2[f][1])
                sd = self.sdet[f, g][None]                    # (1, U)
                n0 = self.snorm[f, g, 0][None]
                n1 = self.snorm[f, g, 1][None]
                if phys.diffusion:
                    jump = (t_sgi - t2_sgi) * sd              # (C, U)
                    pen = self.pen_coef[f] * jump
                    if sip:
                        gavg_n = 0.5 * ud * (
                            (G[0] + G2[f][0]) * n0 + (G[1] + G2[f][1]) * n1)
                        pen = pen - self.cons_coef[f] * gavg_n * sd
                    for i, w in enumerate((w0, w1, w2)):
                        if w != 0.0:
                            out[i] = out[i] + w * pen
                    if sip:
                        # symmetry: - theta k w' (grad N_i . n) jump; ud^2
                        # = 1 cancels between the gradient and the normal
                        for i in range(3):
                            nxn_i = (self.nx1[0, i][None] * n0
                                     + self.nx1[1, i][None] * n1)
                            out[i] = out[i] - self.sym_coef[f] * nxn_i * jump
                if phys.advection:
                    un = ud * (phys.u[0] * n0 + phys.u[1] * n1)
                    income = 0.5 + 0.5 * torch.sign(-un)
                    s_cont = (theta * un * sd
                              * ((1.0 - income) * t_sgi + income * t2_sgi))
                    for i, w in enumerate((w0, w1, w2)):
                        if w != 0.0:
                            out[i] = out[i] + w * s_cont
        return torch.stack(out)
