"""The plain reference that decides ``correct``: straightforward PyTorch and
NumPy, float64 by default, independent of the program (it imports nothing of
``pcr_tpu_torch`` or ``pcr_tpu``, and takes no weights, tables or derived
clouds from them: it works from the scans, poses and information the
benchmark made).

* ``icp``: point-to-plane ICP on plainly voxelised scans, exact 1-NN, target
  normals by PCA of 20 neighbours: the relative pose a registration should
  find, started from the true pose.
* ``fitness`` and ``information``: the inlier share and the (6, 6)
  information matrix sum G^T G, G = [-skew(q) | I], over exact 1-NN
  correspondences within a distance, at a given pose.
* ``lum``, ``slerp``, ``slerp_lum``: the circuit's closed forms (Lu-Milios
  least squares by a dense solve, SLERP of the forward and backward
  rotation chains by ``scipy.spatial.transform``).
* ``pose_graph``: the line-process Levenberg-Marquardt of Choi, Zhou and
  Koltun as Open3D's ``global_optimization`` runs it (optimise, prune
  uncertain edges below the threshold, re-optimise), dense normal
  equations, Jacobians by central differences.

Every function takes ``dtype``: the controls run the same code one precision
below the program's (bfloat16 where the program computes in float32,
float32 where it computes in float64).  Where torch has no kernel of that
type (a solve, an eigen-decomposition), the inputs are rounded to it, the
step runs in float32 and its result is rounded back.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
NN_CHUNK = 2048


def _solve(A, b):
    if A.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve(A, b)
    return torch.linalg.solve(A.float(), b.float()).to(A.dtype)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp_se3(xi):
    """(..., 6) twist (omega, t) -> (..., 4, 4), Rodrigues."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = th2.clamp_min(1e-300).sqrt()
    small = th2 < 1e-10
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2.clamp_min(1e-300))
    c = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (th2 * th).clamp_min(1e-300))
    K = skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * (K @ K)
    V = eye + b[..., None, None] * K + c[..., None, None] * (K @ K)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def log_se3(T):
    """(..., 4, 4) -> (..., 6) twist (omega, t): the rotation angle from the
    quaternion (robust at every angle), V^-1 t for the translation."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    qw = 0.5 * (1 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]).clamp_min(0).sqrt()
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5        # sin(th) * axis
    s = torch.linalg.norm(v, dim=-1)
    th = torch.atan2(s, 2 * qw * qw - 1)                           # cos(th) = 2 qw^2 - 1
    small = s < 1e-9
    scale = torch.where(small, 1 + th * th / 6, th / s.clamp_min(1e-300))
    w = scale[..., None] * v
    th2 = (w * w).sum(-1)
    K = skew(w)
    half = th / 2
    cot = torch.where(th2 < 1e-10, 1.0 / 12 + th2 / 720,
                      (1 - half * torch.cos(half) / torch.sin(half).clamp_min(1e-300))
                      / th2.clamp_min(1e-300))
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    Vinv = eye - 0.5 * K + cot[..., None, None] * (K @ K)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def inv_se3(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.zeros_like(T)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3] = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1
    return out


# ---------------------------------------------------------------------------
# Clouds
# ---------------------------------------------------------------------------

def voxel_down(p, voxel: float):
    """Centroids of the occupied ``voxel`` cells of (n, 3) points."""
    keys = torch.floor(p.double() / voxel).long()
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    m = int(inv.max()) + 1
    s = torch.zeros((m, 3), dtype=F64, device=p.device).index_add_(0, inv, p.double())
    c = torch.zeros(m, dtype=F64, device=p.device).index_add_(0, inv, torch.ones_like(inv, dtype=F64))
    return (s / c[:, None]).to(p.dtype)


def nn1(q, r):
    """(d2, index) of each query's nearest reference row, exact, by chunks of
    the expanded distance in the inputs' dtype."""
    rn = (r * r).sum(-1)
    d_out, i_out = [], []
    for a in range(0, q.shape[0], NN_CHUNK):
        qa = q[a:a + NN_CHUNK]
        d2 = (qa * qa).sum(-1)[:, None] + rn[None, :] - 2 * qa @ r.T
        d, i = d2.min(dim=1)
        d_out.append(d.clamp_min(0))
        i_out.append(i)
    return torch.cat(d_out), torch.cat(i_out)


def knn(p, k: int):
    out = []
    pn = (p * p).sum(-1)
    for a in range(0, p.shape[0], NN_CHUNK):
        pa = p[a:a + NN_CHUNK]
        d2 = (pa * pa).sum(-1)[:, None] + pn[None, :] - 2 * pa @ p.T
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
    return torch.cat(out)


def normals(p, k: int = 20):
    """Unit normals by PCA of each point's k nearest neighbours."""
    nb = p[knn(p, k)]                                     # (n, k, 3)
    d = nb - nb.mean(1, keepdim=True)
    cov = d.transpose(1, 2) @ d
    work = cov if cov.dtype in (torch.float32, torch.float64) else cov.float()
    # cuSOLVER's batched eigh takes a bounded batch
    vec = torch.cat([torch.linalg.eigh(c)[1][..., 0] for c in work.split(NN_CHUNK)])
    return vec.to(cov.dtype)


def _moved(p, T):
    return p @ T[:3, :3].T + T[:3, 3]


def icp(src, tgt, T0, *, voxel: float, max_dist: float, iterations: int = 60,
        dtype=F64) -> np.ndarray:
    """Point-to-plane ICP of ``src`` onto ``tgt`` ((n, 3) host arrays) from
    ``T0``: both voxelised at ``voxel``, correspondences within ``max_dist``.
    Returns the (4, 4) pose as float64 numpy."""
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    s = voxel_down(torch.as_tensor(src, device=dev, dtype=F64), voxel).to(dtype)
    t = voxel_down(torch.as_tensor(tgt, device=dev, dtype=F64), voxel).to(dtype)
    nt = normals(t)
    T = torch.as_tensor(T0, device=dev, dtype=F64).to(dtype)
    for _ in range(iterations):
        p = _moved(s, T)
        d2, j = nn1(p, t)
        keep = d2 <= max_dist * max_dist
        p, q, n = p[keep], t[j[keep]], nt[j[keep]]
        r = ((p - q) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(p, n, dim=-1), n], -1)      # (m, 6)
        delta = _solve(J.T @ J, -(J.T @ r))
        T = exp_se3(delta.to(dtype)) @ T
        if float(delta.double().abs().max()) < 1e-10:
            break
    return T.double().cpu().numpy()


def _correspondences(src, tgt, T, max_dist, dtype, device):
    s = torch.as_tensor(src, device=device, dtype=F64).to(dtype)
    t = torch.as_tensor(tgt, device=device, dtype=F64).to(dtype)
    d2, j = nn1(_moved(s, torch.as_tensor(T, device=device, dtype=F64).to(dtype)), t)
    return d2 <= max_dist * max_dist, t[j]


def fitness(src, tgt, T, max_dist: float, dtype=F64) -> float:
    """Share of ``src`` points within ``max_dist`` of ``tgt`` at pose T."""
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    keep, _ = _correspondences(src, tgt, T, max_dist, dtype, dev)
    return float(keep.double().mean())


def information(src, tgt, T, max_dist: float, dtype=F64) -> np.ndarray:
    """(6, 6) sum G^T G over the correspondences of ``src`` at pose T in
    ``tgt`` within ``max_dist``, G = [-skew(q) | I] of the matched target
    point q."""
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    keep, q = _correspondences(src, tgt, T, max_dist, dtype, dev)
    q = q[keep]
    G = torch.cat([-skew(q), torch.eye(3, dtype=q.dtype, device=dev).expand(q.shape[0], 3, 3)],
                  -1)
    return torch.einsum("nij,nik->jk", G, G).double().cpu().numpy()


# ---------------------------------------------------------------------------
# Closed forms (host, numpy)
# ---------------------------------------------------------------------------

def _rot(T_rel, dtype):
    return np.asarray(T_rel, dtype)[:, :3, :3], np.asarray(T_rel, dtype)[:, :3, 3]


def _lum_translations(Rabs, t, dtype):
    """Least squares of X_1..X_{n-1} (X_0 = 0) from the observations
    X_{i+1} - X_i = R_abs[i] t_i around the closed circuit (X_n = X_0),
    by a dense solve of the normal equations."""
    n = t.shape[0]
    Lb = np.einsum("nij,nj->ni", Rabs, t).astype(dtype)
    A = np.zeros((n, n - 1), dtype)
    for i in range(n):
        if i + 1 <= n - 1:
            A[i, i] = 1.0            # + X_{i+1}
        if i >= 1:
            A[i, i - 1] = -1.0       # - X_i
    X = np.linalg.solve(A.T @ A, A.T @ Lb).astype(dtype)
    return np.concatenate([np.zeros((1, 3), dtype), X])


def _poses(R, X):
    out = np.zeros((R.shape[0], 4, 4), R.dtype)
    out[:, :3, :3], out[:, :3, 3], out[:, 3, 3] = R, X, 1
    return out


def lum(T_rel, dtype=np.float64) -> np.ndarray:
    """The reference's LUM: node i's rotation R_{i-1} ... R_0 (node 0 the
    identity), translations by Lu-Milios least squares."""
    R, t = _rot(T_rel, dtype)
    n = R.shape[0]
    Rabs = [np.eye(3, dtype=dtype)]
    for i in range(n - 1):
        Rabs.append((R[i] @ Rabs[-1]).astype(dtype))
    Rabs = np.stack(Rabs)
    return _poses(Rabs, _lum_translations(Rabs, t, dtype))


def quaternion(R) -> np.ndarray:
    """Unit quaternions (x, y, z, w) of (n, 3, 3) matrices by Shepperd's
    method (the largest of the four denominators), normalised: the
    reference's conversion, which also projects a matrix that is orthogonal
    only to the file's rounding."""
    R = np.asarray(R, np.float64)
    m = lambda i, j: R[:, i, j]                                  # noqa: E731
    tr = m(0, 0) + m(1, 1) + m(2, 2)
    cands = np.stack([
        np.stack([m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1), 1 + tr], -1),
        np.stack([1 + m(0, 0) - m(1, 1) - m(2, 2), m(0, 1) + m(1, 0), m(0, 2) + m(2, 0),
                  m(2, 1) - m(1, 2)], -1),
        np.stack([m(0, 1) + m(1, 0), 1 - m(0, 0) + m(1, 1) - m(2, 2), m(1, 2) + m(2, 1),
                  m(0, 2) - m(2, 0)], -1),
        np.stack([m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), 1 - m(0, 0) - m(1, 1) + m(2, 2),
                  m(1, 0) - m(0, 1)], -1)], 1)                    # (n, 4, 4)
    dens = np.stack([1 + tr, 1 + m(0, 0) - m(1, 1) - m(2, 2), 1 - m(0, 0) + m(1, 1) - m(2, 2),
                     1 - m(0, 0) - m(1, 1) + m(2, 2)], -1)
    q = cands[np.arange(len(R)), np.argmax(dens, -1)]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _slerp_rotations(R, dtype):
    """Node rotations of the reference's circuit SLERP: the forward chain of
    the relative rotations' quaternions a_i = q_{i-1} ... q_0 and the
    backward estimate c_i = a_i C^-1 (C the whole circuit's product), node i
    at slerp(a_i, c_i, i / n) (``scipy.spatial.transform``)."""
    from scipy.spatial.transform import Rotation, Slerp

    n = R.shape[0]
    q = Rotation.from_quat(quaternion(R))
    fwd = [q[0]]
    for i in range(1, n):
        fwd.append(q[i] * fwd[-1])
    closure_inv = fwd[-1].inv()
    out = [np.eye(3)]
    for i in range(1, n):
        a = fwd[i - 1]
        key = Rotation.concatenate([a, a * closure_inv])
        out.append(Slerp([0.0, 1.0], key)([i / n]).as_matrix()[0])
    return np.stack(out).astype(dtype)


def slerp(T_rel, dtype=np.float64) -> np.ndarray:
    """The reference's SLERP: adjusted rotations, raw translations chained by
    them (node i holds the translation accumulated before step i)."""
    R, t = _rot(T_rel, dtype)
    Radj = _slerp_rotations(R, dtype)
    rotated = np.einsum("nij,nj->ni", Radj, t).astype(dtype)
    X = np.concatenate([np.zeros((1, 3), dtype), np.cumsum(rotated, 0)[:-1]]).astype(dtype)
    return _poses(Radj, X)


def slerp_lum(T_rel, dtype=np.float64) -> np.ndarray:
    """The reference repository's SLERP+LUM: SLERP rotations, LUM translations
    from the observations those rotations give."""
    R, t = _rot(T_rel, dtype)
    Radj = _slerp_rotations(R, dtype)
    return _poses(Radj, _lum_translations(Radj, t, dtype))


def chain_standard(T_rel) -> np.ndarray:
    """A_0 = I, A_{i+1} = A_i rel_i (float64): the start of the pose graph."""
    out = [np.eye(4)]
    for i in range(len(T_rel) - 1):
        out.append(out[-1] @ np.asarray(T_rel[i], np.float64))
    return np.stack(out)


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------

def _residual(Xi, Xj, Tinv):
    return log_se3(Tinv @ inv_se3(Xj) @ Xi)


def _jacobians(Xi, Xj, Tinv, eps: float):
    """d r / d delta_i and d r / d delta_j (E, 6, 6) for left perturbations
    X <- exp(delta) X, by central differences."""
    E = Xi.shape[0]
    Ji = torch.empty((E, 6, 6), dtype=Xi.dtype, device=Xi.device)
    Jj = torch.empty_like(Ji)
    for k in range(6):
        d = torch.zeros((E, 6), dtype=Xi.dtype, device=Xi.device)
        d[:, k] = eps
        Ep, Em = exp_se3(d), exp_se3(-d)
        Ji[:, :, k] = (_residual(Ep @ Xi, Xj, Tinv) - _residual(Em @ Xi, Xj, Tinv)) / (2 * eps)
        Jj[:, :, k] = (_residual(Xi, Ep @ Xj, Tinv) - _residual(Xi, Em @ Xj, Tinv)) / (2 * eps)
    return Ji, Jj


def _rTr(nodes, g):
    r = _residual(nodes[g["src"]], nodes[g["dst"]], g["Tinv"])
    return torch.einsum("ei,eij,ej->e", r, g["info"], r)


def _cost(nodes, l, mu, g):
    rTr = _rTr(nodes, g)
    m = g["mask"].to(nodes.dtype)
    prior = m * g["unc"].to(nodes.dtype) * mu * (l.sqrt() - 1) ** 2
    return float((m * l * rTr).sum() + prior.sum())


def _lm_pass(nodes, g, mu, max_iterations, rel_tol, eps):
    n = nodes.shape[0]
    dt = nodes.dtype
    l = torch.ones(g["src"].shape[0], dtype=dt, device=nodes.device)
    lam, cost = 1e-6, _cost(nodes, l, mu, g)
    it = 0
    while it < max_iterations:
        Xi, Xj = nodes[g["src"]], nodes[g["dst"]]
        r = _residual(Xi, Xj, g["Tinv"])
        Ji, Jj = _jacobians(Xi, Xj, g["Tinv"], eps)
        w = (l * g["mask"].to(dt))[:, None, None] * g["info"]
        H = torch.zeros((n, 6, n, 6), dtype=dt, device=nodes.device)
        b = torch.zeros((n, 6), dtype=dt, device=nodes.device)
        for a, Ja in ((g["src"], Ji), (g["dst"], Jj)):
            b.index_put_((a,), (Ja.transpose(1, 2) @ w @ r[..., None])[..., 0], accumulate=True)
            for c, Jc in ((g["src"], Ji), (g["dst"], Jj)):
                blk = Ja.transpose(1, 2) @ w @ Jc                       # (E, 6, 6)
                H.index_put_((a[:, None, None], torch.arange(6, device=a.device)[None, :, None],
                              c[:, None, None], torch.arange(6, device=a.device)[None, None, :]),
                             blk, accumulate=True)
        Hr = H.reshape(6 * n, 6 * n)[6:, 6:]
        Hd = Hr + torch.diag(lam * (torch.diagonal(Hr) + 1e-12))
        x = _solve(Hd, b.reshape(-1)[6:])
        delta = torch.cat([torch.zeros(6, dtype=dt, device=nodes.device), -x]).reshape(n, 6)
        new_nodes = exp_se3(delta) @ nodes
        rTr = _rTr(new_nodes, g)
        new_l = torch.where(g["unc"], (mu / (mu + rTr)) ** 2, torch.ones_like(rTr))
        new_cost = _cost(new_nodes, new_l, mu, g)
        it += 1
        improved = new_cost < cost
        converged = improved and (cost - new_cost) < rel_tol * (cost + 1e-12)
        if improved:
            nodes, l, cost = new_nodes, new_l, new_cost
        lam = min(max(lam * (0.5 if improved else 4.0), 1e-12), 1e8)
        if converged or lam >= 1e8:
            break
    return nodes, l, it


def pose_graph(nodes0, src, dst, edge_T, info, uncertain, *, max_corr: float,
               prune: float, preference: float = 1.0, max_iterations: int = 100,
               rel_tol: float = 1e-9, dtype=F64):
    """Two line-process LM passes with pruning in between (Open3D's
    ``global_optimization``): edges (src -> dst) carry ``edge_T`` (frame src
    -> frame dst) and (6, 6) ``info`` in (omega, t) order; node 0 is fixed.
    mu = preference * max_corr^2 * the mean correspondence count of the
    uncertain edges (their translation information).  If pruning leaves no
    uncertain edge on a circuit, the second pass starts from the chain of
    the remaining edges.  Returns (nodes (n, 4, 4) float64 numpy, {pass1,
    pass2 iterations, pruned})."""
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev).to(dt)

    g = {"src": torch.as_tensor(np.asarray(src), device=dev, dtype=torch.long),
         "dst": torch.as_tensor(np.asarray(dst), device=dev, dtype=torch.long),
         "Tinv": inv_se3(t(edge_T)), "info": t(info),
         "unc": torch.as_tensor(np.asarray(uncertain), device=dev, dtype=torch.bool)}
    g["mask"] = torch.ones_like(g["unc"])
    tr = np.einsum("eii->e", np.asarray(info, np.float64)[:, 3:, 3:]) / 3
    unc = np.asarray(uncertain, bool)
    mu = preference * max_corr ** 2 * max(tr[unc].mean() if unc.any() else 1.0, 1.0)
    eps = 1e-6 if dtype == F64 else 1e-2
    nodes = t(nodes0)
    nodes, l, it1 = _lm_pass(nodes, g, mu, max_iterations, rel_tol, eps)
    keep = ~g["unc"] | (l >= prune)
    pruned = int((~keep).sum())
    g["mask"] = keep
    n = nodes.shape[0]
    circuit = (np.array_equal(np.asarray(src), np.arange(n))
               and np.array_equal(np.asarray(dst), np.r_[np.arange(1, n), 0]))
    if pruned and circuit and not bool((g["unc"] & keep).any()):
        nodes = t(chain_standard(np.linalg.inv(np.asarray(edge_T, np.float64))))
    nodes, _, it2 = _lm_pass(nodes, g, mu, max_iterations, rel_tol, eps)
    return nodes.double().cpu().numpy(), {"pass1": it1, "pass2": it2, "pruned": pruned,
                                          "mask": keep.cpu().numpy(), "mu": mu}


def objective(nodes, src, dst, edge_T, info, uncertain, mask, mu) -> float:
    """The joint objective in float64 at ``nodes`` over the live edges
    ``mask``, each uncertain edge's line process at its minimiser given the
    nodes, l = (mu / (mu + r^T Info r))^2."""
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    g = {"src": torch.as_tensor(np.asarray(src), device=dev, dtype=torch.long),
         "dst": torch.as_tensor(np.asarray(dst), device=dev, dtype=torch.long),
         "Tinv": inv_se3(t(edge_T)), "info": t(info),
         "unc": torch.as_tensor(np.asarray(uncertain), device=dev, dtype=torch.bool),
         "mask": torch.as_tensor(np.asarray(mask), device=dev, dtype=torch.bool)}
    X = t(nodes)
    rTr = _rTr(X, g)
    l = torch.where(g["unc"], (mu / (mu + rTr)) ** 2, torch.ones_like(rTr))
    return _cost(X, l, mu, g)
