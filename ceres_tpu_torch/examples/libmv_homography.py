"""Homography estimation: an algebraic start, then a refinement of the
symmetric distance.

The reference's examples/libmv_homography.cc: the algebraic (DLT-style)
start from the 3n x 8 system (:200-241), the refinement over the
8-parameter normalized homography (H[2,2] = 1) with the 4-component
symmetric geometric distance (forward |y - Hx| and backward |x - H^-1 y|
terms, :245-266), and an IterationCallback that ends the solve at an
absolute average-distance threshold (:274-308) under
update_state_every_iteration.
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct


def _project(H, p):
    q = H @ torch.stack([p[0], p[1], torch.ones_like(p[0])])
    return q[:2] / q[2]


def symmetric_distance_terms(h8, x, y):
    H = torch.cat([h8, torch.ones_like(h8[:1])]).reshape(3, 3)
    fwd = _project(H, x) - y
    bwd = _project(torch.linalg.inv(H), y) - x
    return torch.cat([fwd, bwd])


def algebraic_init(x1, x2):
    n = x1.shape[0]
    L = np.zeros((3 * n, 8))
    b = np.zeros(3 * n)
    for i in range(n):
        j = 3 * i
        L[j, 0:3] = [x1[i, 0], x1[i, 1], 1.0]
        L[j, 6:8] = [-x2[i, 0] * x1[i, 0], -x2[i, 0] * x1[i, 1]]
        b[j] = x2[i, 0]
        L[j + 1, 3:6] = [x1[i, 0], x1[i, 1], 1.0]
        L[j + 1, 6:8] = [-x2[i, 1] * x1[i, 0], -x2[i, 1] * x1[i, 1]]
        b[j + 1] = x2[i, 1]
        L[j + 2, 0:3] = [x2[i, 1] * x1[i, 0], x2[i, 1] * x1[i, 1], x2[i, 1]]
        L[j + 2, 3:6] = [-x2[i, 0] * x1[i, 0], -x2[i, 0] * x1[i, 1], -x2[i, 0]]
    return np.linalg.lstsq(L, b, rcond=None)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # synthetic ground truth (the reference's hard-coded example pattern)
    H_true = np.asarray([[1.243715, -0.461057, -111.964454],
                         [0.0, 0.617589, -192.379252],
                         [0.0, -0.000983, 1.0]])
    rng = np.random.default_rng(0)
    x1 = rng.uniform(0, 500, (40, 2))
    x2 = np.stack([
        (H_true[:2] @ np.r_[p, 1.0]) / (H_true[2] @ np.r_[p, 1.0]) for p in x1
    ])
    x2 += 0.2 * rng.standard_normal(x2.shape)

    h = algebraic_init(x1, x2)
    print("algebraic H (8-param):", np.round(h, 4))

    cost = ct.AutoDiffCostFunction(
        lambda h8, d: symmetric_distance_terms(h8, d[0], d[1]), 4, [8]
    )
    problem = ct.Problem()
    for p, q in zip(x1, x2):
        problem.add_residual_block(cost, None, [h], data=(p, q))

    expected_avg_distance = 0.3  # px^2 (symmetric squared distance)

    def termination_callback(it):
        if not it.step_is_successful:
            return ct.CallbackReturnType.SOLVER_CONTINUE
        d = 0.0
        for p, q in zip(x1, x2):
            t = symmetric_distance_terms(torch.as_tensor(h), torch.as_tensor(p),
                                         torch.as_tensor(q)).numpy()
            d += float(t @ t)
        d /= len(x1)
        if d <= expected_avg_distance:
            return ct.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ct.CallbackReturnType.SOLVER_CONTINUE

    summary = ct.solve(
        ct.Options(
            max_num_iterations=50,
            update_state_every_iteration=True,
            callbacks=[termination_callback],
        ),
        problem,
        device=args.device,
    )
    print(summary.brief_report())
    H = np.concatenate([h, [1.0]]).reshape(3, 3)
    print("refined H:\n", np.round(H / H[2, 2], 6))
    print("true H:\n", np.round(H_true, 6))
    return summary


if __name__ == "__main__":
    main()
