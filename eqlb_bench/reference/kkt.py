"""The plain reference of the flux equilibration: one dense saddle-point
system per vertex patch (Ern and Vohralik's constrained minimisation, the
algorithm of upstream ``FluxEqlbEV``), assembled here from the mesh and the
data, solved with pivoting by ``torch.linalg.solve`` and summed into the
global RT_k dof vector.

For a vertex z with hat function psi_z and patch omega_z, sigma_z lies in
the RT_k functions on omega_z whose normal trace vanishes on the facets
opposite z, r_z in DG_{k-1}(omega_z), and

    (sigma_z, tau) - (r_z, div tau) = (psi_z sigma_h, tau)
    (div sigma_z, q) + (R r_z, q)   = (psi_z f + grad psi_z . sigma_h, q)

for all tau, q of the same spaces, sigma_h and f the DG_{k-1} data.  On an
interior patch div: RT -> DG is one short of onto (the patch mean), and
R = c c^T / (c^T c), c the moments of the constant, takes up the mean of
the constraint's right-hand side; on a patch at a boundary of primal
Dirichlet kind, R = 0.  The equilibrated flux is sum_z sigma_z.  This is
the same minimisation the semi-explicit mode solves over a divergence-free
basis, so one reference judges both modes.

Plain PyTorch and NumPy: nothing of the program is imported, and nothing
the program made is read.
"""

from __future__ import annotations

import numpy as np
import torch

from .element import HAT_GRADS, reference_tensors
from .topology import Topology


def cell_dofs(topo: Topology, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Global dof ids (nc, k(k+2)) and orientation signs of every cell's
    local RT_k dofs: facet dofs first (facet f's k dofs at f k + m, moments
    along the facet's canonical direction), then the cell's k(k-1) interior
    dofs after all facet dofs.  A local edge that runs against its facet's
    canonical direction sees moment m with the sign (-1)^(m+1)."""
    nc, kk1 = topo.num_cells, k * (k - 1)
    m = np.arange(k)
    gd = np.empty((nc, 3 * k + kk1), dtype=np.int64)
    sg = np.ones((nc, 3 * k + kk1))
    for e in range(3):
        gd[:, e * k:(e + 1) * k] = topo.cell_facets[:, e, None] * k + m
        sg[:, e * k:(e + 1) * k] = np.where(topo.edge_aligned[:, e, None],
                                            1.0, (-1.0) ** (m + 1))
    gd[:, 3 * k:] = (topo.num_facets * k + np.arange(nc)[:, None] * kk1
                     + np.arange(kk1))
    return gd, sg


class Reference:
    """The reference's own topology, patches and dof tables of one mesh at
    RT_k, built once on the host; :meth:`solve` runs the patch systems of
    given data on ``device``."""

    def __init__(self, points: np.ndarray, cells: np.ndarray, k: int,
                 topo: Topology | None = None):
        self.points = np.asarray(points, dtype=np.float64)
        self.k = k
        self.topo = topo if topo is not None else Topology(cells, len(self.points))
        self.gdofs, self.signs = cell_dofs(self.topo, k)
        self.ndofs = self.topo.num_facets * k + self.topo.num_cells * k * (k - 1)
        self.groups = self.topo.patches()

    def patch_sizes(self) -> list[tuple[int, bool, int, int, int]]:
        """Per patch group: (cells n, on the boundary, patches, flux dofs
        nflux, KKT size D = nflux + n k(k+1)/2)."""
        k = self.k
        out = []
        for (n, bnd), (zs, _, _) in sorted(self.groups.items()):
            nflux = (n + bnd) * k + n * k * (k - 1)
            out.append((n, bnd, len(zs), nflux, nflux + n * k * (k + 1) // 2))
        return out

    def solve(self, d_proj: torch.Tensor, d_rhs: torch.Tensor,
              block_bytes: int = 2**31) -> torch.Tensor:
        """Equilibrated fluxes (L, ndofs) of L data sets, on the data's
        device and in its precision: d_proj (L, nc, 2, ndg), the vector DG
        dofs of sigma_h, and d_rhs (L, nc, ndg), those of f, both in the
        Dubiner basis of DG_{k-1}.  Every boundary facet is of primal
        Dirichlet kind.  The patches go in blocks of about ``block_bytes``
        of systems."""
        dev, dt = d_proj.device, d_proj.dtype
        k = self.k
        ref = {name: torch.as_tensor(a, dtype=dt, device=dev)
               for name, a in reference_tensors(k).items()}
        hat = torch.as_tensor(HAT_GRADS, dtype=dt, device=dev)
        cells = self.topo.cells
        pts = self.points
        J = np.stack([pts[cells[:, 1]] - pts[cells[:, 0]],
                      pts[cells[:, 2]] - pts[cells[:, 0]]], axis=-1)
        geo = {"J": torch.as_tensor(J, dtype=dt, device=dev)}
        x = d_proj.new_zeros((d_proj.shape[0], self.ndofs))
        for (n, bnd), (zs, pc, pl) in sorted(self.groups.items()):
            D = (n + bnd) * k + n * k * (k - 1) + n * k * (k + 1) // 2
            step = max(1, block_bytes // (4 * 8 * D * D))
            for s in range(0, len(zs), step):
                self._block(x, d_proj, d_rhs, geo, ref, hat,
                            pc[s:s + step], pl[s:s + step], n, bnd)
        return x

    def _block(self, x, d_proj, d_rhs, geo, ref, hat, pcells, plnode, n,
               bnd):
        dev, dt = d_proj.device, d_proj.dtype
        k = self.k
        ndg = k * (k + 1) // 2
        nrt = k * (k + 2)
        nkeep = nrt - k
        P, L = len(pcells), d_proj.shape[0]
        # each cell keeps every local dof but those of its edge opposite z
        keep = np.array([[i for i in range(nrt) if not l * k <= i < l * k + k]
                         for l in range(3)])
        kidx = keep[plnode]  # (P, n, nkeep)
        c64 = torch.as_tensor(pcells, device=dev)
        G = torch.as_tensor(np.take_along_axis(self.gdofs[pcells], kidx, 2),
                            device=dev).reshape(P, n * nkeep)
        S = torch.as_tensor(np.take_along_axis(self.signs[pcells], kidx, 2),
                            dtype=dt, device=dev)
        kk = torch.as_tensor(kidx, device=dev)
        ln = torch.as_tensor(plnode, device=dev)
        # patch-local numbering of the flux dofs: rank among the distinct
        # global ids of the patch
        srt, order = torch.sort(G, dim=1)
        rank = torch.cat([srt.new_zeros((P, 1)),
                          (srt[:, 1:] != srt[:, :-1]).long().cumsum(1)], 1)
        nflux = (n + bnd) * k + n * k * (k - 1)
        if int(rank[:, -1].max()) + 1 != nflux or int(rank[:, -1].min()) + 1 != nflux:
            raise RuntimeError("patch flux space of unexpected size")
        pos = torch.empty_like(rank).scatter_(1, order, rank)
        uniq = torch.empty_like(G[:, :nflux]).scatter_(1, pos, G)
        pos = pos.view(P, n, nkeep)
        D = nflux + n * ndg

        # element tensors of the patch cells
        J = geo["J"][c64]  # (P, n, 2, 2)
        detJ = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        adet, sdet = detJ.abs(), torch.sign(detJ)
        Kinv = torch.linalg.inv(J)
        M = torch.einsum("pcka,pckb,abij->pcij", J, J, ref["Mhat"])
        M = M / adet[..., None, None]
        M = torch.gather(M, 2, kk[..., None].expand(P, n, nkeep, nrt))
        M = torch.gather(M, 3, kk[:, :, None, :].expand(P, n, nkeep, nkeep))
        M = M * S[..., :, None] * S[..., None, :]
        B = sdet[..., None, None] * ref["Dhat"][kk] * S[..., None]  # (P,n,nkeep,ndg)
        dp = d_proj[:, c64]  # (L, P, n, 2, ndg)
        fr = d_rhs[:, c64]  # (L, P, n, ndg)
        Rl = ref["Rhat"][ln]  # (P, n, ndg, 2, nrt)
        Fv = torch.einsum("rpcam,pcab,pcmbi->rpci", dp, J, Rl)
        Fv = torch.gather(Fv, 3, kk[None].expand(L, P, n, nkeep))
        Fv = Fv * (sdet[..., None] * S)[None]
        gpsi = torch.einsum("pcba,pcb->pca", Kinv, hat[ln])
        Fq = (torch.einsum("rpcm,pcmq->rpcq", fr, ref["T3"][ln])
              + torch.einsum("pca,rpcaq->rpcq", gpsi, dp)) * adet[None, ..., None]

        # assembly into (P, D, D) and (P, D, L)
        qrow = nflux + torch.arange(n, device=dev)[:, None] * ndg \
            + torch.arange(ndg, device=dev)  # (n, ndg)
        A = d_proj.new_zeros((P, D * D))
        A.scatter_add_(1, (pos[..., :, None] * D + pos[..., None, :]).reshape(P, -1),
                       M.reshape(P, -1))
        A.scatter_add_(1, (pos[..., :, None] * D + qrow[None, :, None, :]).reshape(P, -1),
                       (-B).reshape(P, -1))
        A.scatter_add_(1, (qrow[None, :, None, :] * D + pos[..., :, None]).reshape(P, -1),
                       B.reshape(P, -1))
        A = A.view(P, D, D)
        if not bnd:
            c = (adet[..., None] * ref["cmean"]).reshape(P, n * ndg)
            A[:, nflux:, nflux:] += (c[:, :, None] * c[:, None, :]
                                     / (c * c).sum(1)[:, None, None])
        rhs = d_proj.new_zeros((P, D, L))
        rhs.scatter_add_(1, pos.reshape(P, -1, 1).expand(P, n * nkeep, L),
                         Fv.permute(1, 2, 3, 0).reshape(P, -1, L))
        rhs[:, nflux:] = Fq.permute(1, 2, 3, 0).reshape(P, n * ndg, L)
        sol = torch.linalg.solve(A, rhs)[:, :nflux]  # (P, nflux, L)
        x.index_add_(1, uniq.reshape(-1), sol.permute(2, 0, 1).reshape(L, -1))
