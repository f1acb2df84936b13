"""Seeded inputs of the loop solvers' kernels (csrc/ransac.cu,
csrc/sim3_opt.cu, csrc/voc_transform.cu), shared by the CPU tests and the
card tests (no JAX here): EPnP and Sim3 RANSAC scenes with outliers,
OptimizeSim3 problems and full k-ary vocabulary trees, all numpy from a
seed."""
import numpy as np

FX, FY, CX, CY = 400.0, 400.0, 320.0, 180.0


def rot(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K) \
        .astype(np.float32)


def project(x: np.ndarray) -> np.ndarray:
    return np.stack([FX * x[:, 0] / x[:, 2] + CX,
                     FY * x[:, 1] / x[:, 2] + CY], 1)


def samples(rng, n: int, H: int, m: int, distinct: bool) -> np.ndarray:
    """[H, m] int32 sample indices: without repeats in a row (distinct), or
    drawn as the SLAM draws them (rng.integers, repeats possible)."""
    if distinct:
        return np.stack([rng.choice(n, m, replace=False)
                         for _ in range(H)]).astype(np.int32)
    return rng.integers(0, n, (H, m)).astype(np.int32)


def pnp_case(seed: int, n: int = 200, n_out: int = 40, noise: float = 0.5,
             H: int = 64, distinct: bool = True):
    """(pw [n, 3], uv [n, 2], valid [n], max_err2 [n], sample_idx [H, 4])
    numpy: world points seen from a known pose, n_out of them moved 20-60
    px, the chi-square gate of octave 1 (5.991 x 1.2^2)."""
    rng = np.random.default_rng(seed)
    pw = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3)).astype(np.float32)
    R = rot([0.05, 0.2, -0.1])
    t = np.array([0.3, -0.1, 0.4], np.float32)
    uv = project(pw @ R.T + t) + rng.normal(0, noise, (n, 2))
    out = rng.choice(n, n_out, replace=False)
    uv[out] += rng.uniform(20, 60, (n_out, 2))
    valid = np.ones(n, bool)
    max_err2 = np.full(n, 5.991 * 1.44, np.float32)
    return (pw, uv.astype(np.float32), valid, max_err2,
            samples(rng, n, H, 4, distinct))


def sim3_case(seed: int, n: int = 150, n_out: int = 30, scale: float = 1.0,
              H: int = 64, distinct: bool = True):
    """(x1 [n, 3], x2 [n, 3], valid [n], max_err1 [n], max_err2 [n],
    sample_idx [H, 3]) numpy: x1 = scale R x2 + t with 1 cm noise, n_out
    pairs moved 1-3 m, gates 9.21 x sigma^2 of octaves 0-2."""
    rng = np.random.default_rng(seed)
    x2 = rng.uniform([-3, -2, 4], [3, 2, 15], (n, 3)).astype(np.float32)
    R = rot([0.05, 0.3, -0.1])
    t = np.array([0.5, -0.2, 0.8], np.float32)
    x1 = scale * x2 @ R.T + t + rng.normal(0, 0.01, (n, 3))
    out = rng.choice(n, n_out, replace=False)
    x1[out] += rng.uniform(1, 3, (n_out, 3))
    valid = np.ones(n, bool)
    valid[rng.choice(n, 3, replace=False)] = False
    sig = 1.2 ** (2 * rng.integers(0, 3, (2, n)))
    return (x1.astype(np.float32), x2, valid,
            (9.21 * sig[0]).astype(np.float32),
            (9.21 * sig[1]).astype(np.float32),
            samples(rng, n, H, 3, distinct))


def opt_case(seed: int, n: int = 300, scale: float = 1.0):
    """OptimizeSim3's inputs (R0, t0, s0, x1, obs1, sig1, x2, obs2, sig2,
    valid) numpy: mutual observations with 0.3 px noise, n // 20 outliers
    in camera 1, a start 0.03 rad and ~6 cm off."""
    n_out = n // 20
    rng = np.random.default_rng(seed)
    x2 = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3)).astype(np.float32)
    R = rot([0.02, 0.2, -0.05])
    t = np.array([0.3, -0.1, 0.5], np.float32)
    x1 = (scale * x2 @ R.T + t).astype(np.float32)
    obs1 = project(x1) + rng.normal(0, 0.3, (n, 2))
    obs2 = project(x2) + rng.normal(0, 0.3, (n, 2))
    obs1[:n_out] += 30.0
    R0 = (rot([0.0, 0.03, 0.0]) @ R).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.02])).astype(np.float32)
    sig1 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    sig2 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n_out:n_out + 2] = False
    return (R0, t0, np.float32(1.0), x1, obs1.astype(np.float32), sig1,
            x2, obs2.astype(np.float32), sig2, valid)


def full_tree(seed: int, k: int, depth: int):
    """A full k-ary tree of the given depth in the Vocabulary layout, nodes
    numbered level by level: (children [nodes, k] int32, node_desc32
    [nodes, 8] uint32 random, word_id [nodes] int32: the leaves in
    order)."""
    rng = np.random.default_rng(seed)
    nodes = (k ** (depth + 1) - 1) // (k - 1)
    internal = (k ** depth - 1) // (k - 1)
    children = np.full((nodes, k), -1, np.int32)
    children[:internal] = np.arange(internal)[:, None] * k + 1 + np.arange(k)
    desc = rng.integers(0, 2 ** 32, (nodes, 8), dtype=np.uint64) \
        .astype(np.uint32)
    word_id = np.full(nodes, -1, np.int32)
    word_id[internal:] = np.arange(nodes - internal)
    return children, desc, word_id


def words(seed: int, n: int) -> np.ndarray:
    """n random descriptors [n, 8] uint32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
