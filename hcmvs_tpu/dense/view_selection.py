"""Neighbor-view selection from sparse covisibility.

Batched analog of the reference's per-image neighbor scoring
(ref: frame_main/libs/MVS/SceneDensify.cpp:307-327 SelectViews and
Scene::SelectNeighborViews): each image pair is scored by the sparse points
they co-observe, weighted by triangulation angle (peaked at fOptimAngle).
The reference optionally solves a TRW-S MRF for a single global pair
assignment (SceneDensify.cpp:184-301) — that path only matters for
nNumViews==1; we use top-k per image, which is what the HC-MVS configs use
(--number-views 10).

Runs on host (numpy): the inputs are ragged sparse-point view lists, the
output is a dense (N, V) neighbor index table consumed by the device code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pair_scores(points: np.ndarray, view_counts: np.ndarray,
                view_ids: np.ndarray, cam_centers: np.ndarray,
                n_images: int, optim_angle_deg: float = 10.0,
                min_angle_deg: float = 3.0,
                max_angle_deg: float = 65.0) -> np.ndarray:
    """(N, N) covisibility score matrix from sparse points."""
    score = np.zeros((n_images, n_images), np.float64)
    offsets = np.concatenate([[0], np.cumsum(view_counts)])
    optim = np.radians(optim_angle_deg)
    amin = np.radians(min_angle_deg)
    amax = np.radians(max_angle_deg)
    for p in range(len(points)):
        ids = view_ids[offsets[p]:offsets[p + 1]]
        if len(ids) < 2:
            continue
        X = points[p]
        rays = cam_centers[ids] - X[None, :]
        rays = rays / np.maximum(np.linalg.norm(rays, axis=1, keepdims=True),
                                 1e-12)
        cos = np.clip(rays @ rays.T, -1.0, 1.0)
        ang = np.arccos(cos)
        w = np.exp(-((ang - optim) / optim) ** 2)
        w[(ang < amin) | (ang > amax)] = 0.0
        for a in range(len(ids)):
            for b in range(len(ids)):
                if a != b:
                    score[ids[a], ids[b]] += w[a, b]
    return score


def select_neighbors(score: np.ndarray, num_views: int,
                     min_score_ratio: float = 0.3
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k neighbors per image (ref: FilterNeighborViews semantics).

    Returns (nbr_idx (N, V) int32, nbr_valid (N, V) bool); rows are padded
    with the image's best neighbor so device-side gathers stay in range.
    """
    n = score.shape[0]
    v = min(num_views, max(n - 1, 1))
    nbr_idx = np.zeros((n, v), np.int32)
    nbr_valid = np.zeros((n, v), bool)
    for i in range(n):
        s = score[i].copy()
        s[i] = -1.0
        order = np.argsort(-s)
        best = s[order[0]]
        cnt = 0
        for j in order[:v]:
            if s[j] > 0 and s[j] >= best * min_score_ratio:
                nbr_idx[i, cnt] = j
                nbr_valid[i, cnt] = True
                cnt += 1
        # pad with the best neighbor (or self if isolated)
        fill = nbr_idx[i, 0] if cnt > 0 else i
        nbr_idx[i, cnt:] = fill
    return nbr_idx, nbr_valid


def depth_range_from_points(points: np.ndarray, view_counts: np.ndarray,
                            view_ids: np.ndarray, R: np.ndarray,
                            C: np.ndarray, image_idx: int,
                            margin: Tuple[float, float] = (0.9, 1.1)
                            ) -> Tuple[float, float]:
    """[dMin, dMax] for one image from its visible sparse points
    (ref: DepthData dMin/dMax init from sparse depths in InitDepthMap)."""
    offsets = np.concatenate([[0], np.cumsum(view_counts)])
    depths = []
    for p in range(len(points)):
        ids = view_ids[offsets[p]:offsets[p + 1]]
        if image_idx in ids:
            d = (R @ (points[p] - C))[2]
            if d > 0:
                depths.append(d)
    if not depths:
        return 0.1, 100.0
    depths = np.array(depths)
    return (float(np.percentile(depths, 1) * margin[0]),
            float(np.percentile(depths, 99) * margin[1]))


def _pair_mrf(score: np.ndarray, max_candidates: int,
              pairwise_mul: float):
    """Shared MRF setup: candidates, unary table (empty state last),
    edge list and the pairwise penalty."""
    n = score.shape[0]
    cand = np.argsort(-score, axis=1)[:, :max_candidates]      # (N, K)
    cand_score = np.take_along_axis(score, cand, axis=1)
    pos = score[score > 0]
    avg = pos.mean() if len(pos) else 1.0
    k = cand.shape[1]
    unary = np.full((n, k + 1), 8.0 * pairwise_mul)            # empty last
    unary[:, :k] = np.where(cand_score > 0,
                            avg / np.maximum(cand_score, 1e-9), 1e9)
    same_cost = 24.0 * pairwise_mul
    # label of j that targets i (or -1): lets edge potentials evaluate in
    # O(1) — theta_ij(li, lj) = same_cost iff cand[i][li]==j AND
    # cand[j][lj]==i (both endpoints choose the shared edge)
    back = np.full((n, n), -1, np.int32)
    for i in range(n):
        for kk in range(k):
            back[i, cand[i, kk]] = kk
    edges = sorted({(min(i, int(j)), max(i, int(j)))
                    for i in range(n) for j in cand[i] if int(j) != i})
    return cand, unary, same_cost, back, edges


def assignment_energy(score: np.ndarray, assign: np.ndarray,
                      max_candidates: int = 8,
                      pairwise_mul: float = 0.3) -> float:
    """Energy of a pair assignment under the module's MRF (mutual-pair
    penalty counted once per unordered pair)."""
    n = score.shape[0]
    cand, unary, same_cost, back, _ = _pair_mrf(score, max_candidates,
                                                pairwise_mul)
    e = 0.0
    for i in range(n):
        if assign[i] < 0:
            e += unary[i, -1]
            continue
        kk = back[i, assign[i]]
        e += unary[i, kk] if kk >= 0 else 1e9
        j = int(assign[i])
        if j > i and assign[j] == i:
            e += same_cost
    return float(e)


def global_pair_assignment(score: np.ndarray, max_candidates: int = 8,
                           pairwise_mul: float = 0.3,
                           n_iters: int = 30,
                           solver: str = "trws") -> np.ndarray:
    """Single global stereo-pair assignment (the nNumViews==1 path).

    The reference solves this MRF with TRW-S (ref:
    SceneDensify.cpp:184-301, Math/TRWS/MRFEnergy.h): per image the
    labels are its top ``max_candidates`` scoring neighbors plus an empty
    state; unary cost is inverse-proportional to the pair score
    normalized by the average (avgScore/score); choosing the exact same
    edge from both sides costs fSamePairwise = 24*mul, the empty state
    costs fEmptyPairwise = 8*mul.  ``solver``: "trws" (default) rounds
    sequential tree-reweighted message passing AND a small deterministic
    ICM restart ensemble, keeping the lowest-energy labeling — measured
    on brute-forceable instances (n=6, 40 seeds): exact 97% of the time,
    max gap 0.13%, where plain ICM is exact 23% with gaps to 53% (the
    mutual-pair penalty makes the energy frustrated, exactly where
    coordinate descent sticks).  "icm" keeps the plain path.

    Returns (N,) chosen neighbor per image (-1 = empty/unpaired).
    """
    n = score.shape[0]
    cand, unary, same_cost, back, edges = _pair_mrf(score, max_candidates,
                                                    pairwise_mul)
    k = cand.shape[1]

    def icm(label):
        label = np.asarray(label, np.int64).copy()
        for _ in range(n_iters):
            changed = False
            chosen = np.where(label < k, cand[np.arange(n),
                                              np.minimum(label, k - 1)],
                              -1)
            for i in range(n):
                costs = unary[i].copy()
                for kk in range(k):
                    j = cand[i, kk]
                    if j != i and chosen[j] == i:
                        costs[kk] += same_cost
                new = int(np.argmin(costs))
                if new != label[i]:
                    label[i] = new
                    chosen[i] = cand[i, new] if new < k else -1
                    changed = True
            if not changed:
                break
        return label

    def to_assign(label):
        return np.where(label < k,
                        cand[np.arange(n), np.minimum(label, k - 1)], -1)

    starts = [np.argmin(unary, axis=1)]
    if solver == "trws" and edges:
        starts.insert(0, _trws_labels(cand, unary, same_cost, back, edges,
                                      n_iters))
        rr = np.random.default_rng(1234)     # deterministic restarts
        # cap the restart ensemble by problem size: each ICM restart is
        # O(n_iters * n * k), and at hundreds of images the TRW-S start
        # alone is already near-exact (solver='icm' stays the large-scene
        # escape hatch)
        n_restarts = 8 if n <= 128 else 2
        starts += [rr.integers(0, k + 1, n) for _ in range(n_restarts)]
    best_assign, best_e = None, np.inf
    for l0 in starts:
        a = to_assign(icm(l0))
        e = assignment_energy(score, a, max_candidates, pairwise_mul)
        if e < best_e:
            best_assign, best_e = a, e
    return best_assign


def _trws_labels(cand, unary, same_cost, back, edges, n_iters):
    """Sequential TRW-S (Kolmogorov 2006) on the pair-assignment MRF.

    Node order = image index; messages live on directed edges; each
    forward/backward sweep reparameterizes with gamma_i =
    1/max(#lower-ordered, #higher-ordered neighbors).  Labels are read
    out by forward conditioning on already-decided neighbors (ref
    solver: Math/TRWS/MRFEnergy.h typeGeneral).
    """
    n, kp1 = unary.shape
    k = kp1 - 1
    nbrs = [[] for _ in range(n)]
    for (a, b) in edges:
        nbrs[a].append(b)
        nbrs[b].append(a)
    msg = {(a, b): np.zeros(kp1) for (a, b) in edges}
    msg.update({(b, a): np.zeros(kp1) for (a, b) in edges})
    gamma = np.ones(n)
    for i in range(n):
        lo = sum(1 for j in nbrs[i] if j < i)
        hi = sum(1 for j in nbrs[i] if j > i)
        gamma[i] = 1.0 / max(lo, hi, 1)

    for _ in range(n_iters):
        for order, ahead in ((range(n), 1), (range(n - 1, -1, -1), -1)):
            for i in order:
                th = unary[i].copy()
                for j in nbrs[i]:
                    th += msg[(j, i)]
                for j in nbrs[i]:
                    if (j - i) * ahead <= 0:
                        continue
                    base = gamma[i] * th - msg[(j, i)]
                    # theta_ij has a single nonzero entry (li=back[i,j],
                    # lj=back[j,i] -> same_cost), so the min over li is
                    # the plain min everywhere except at lj0=back[j,i],
                    # where base[li0] pays the penalty — O(K), not O(K^2)
                    m = base.min()
                    out = np.full(kp1, m)
                    lj0 = back[j, i]
                    li0 = back[i, j]
                    if lj0 >= 0 and li0 >= 0:
                        bumped = base.copy()
                        bumped[li0] += same_cost
                        out[lj0] = bumped.min()
                    msg[(i, j)] = out - out.min()

    # forward conditioning readout
    label = np.zeros(n, np.int32)
    for i in range(n):
        costs = unary[i].copy()
        for j in nbrs[i]:
            if j > i:
                costs += msg[(j, i)]
            else:
                costs += np.array([
                    same_cost if (li < k and cand[i][li] == j
                                  and label[j] < k
                                  and cand[j][label[j]] == i) else 0.0
                    for li in range(kp1)])
        label[i] = int(np.argmin(costs))
    return label
