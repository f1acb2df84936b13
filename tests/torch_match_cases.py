"""Seeded inputs of ops/match_kernels.match_rows, shared by the CPU tests
(tests/test_torch_match_kernels.py), the card tests
(tests/test_torch_cuda.py) and tools/match_grid.py; numpy and torch only,
no JAX.

``make(mode, case, rng, P, N, B)`` -> a case: numpy rows and columns
shaped as the matchers give them (columns spread over a 640 x 360 image
at 8 octaves, about 70% of the rows derived from a column: its position
moved by a few pixels, a few descriptor bits flipped; duplicated columns
make ties), with the mode's th, ratio, band, max_d, resolve, rotation
angles and sigma2 table.  ``args(c, device)`` -> match_rows' positional
arguments (mode, rows, cols, th, ratio, band, max_d, resolve, angles,
sigma2).

Cases: "path" as above, and the grid of cells' edge cases: "border"
(windows over the image border, columns on it), "cell boundaries"
(columns on multiples of 10 and 7.5 px, the 64 x 48 grid's boundaries
over [0, 640] x [0, 360], and windows whose ends fall on them),
"non-finite" (rows and columns with NaN or infinite coordinates, radii,
bands), "one cell" (every column in a 0.5 px square; bow: one key),
"empty windows" (radii of 0 or less, windows off the image; bow: keys no
column has), "no gated pair" (rows whose octave or key matches no
column) and "wide windows" (radii of 100 px, stereo's band 30 px and
disparities to 640 px at one octave, so a row has hundreds of candidates
and stereo's rows more gated pairs than a warp lists; bow: three keys).

Epipolar mode (triangulation's search: a row's line in each of B
targets, the columns' sigma2 of their octave) reads the cases so: "path"
lines through a column of each target (a few pixels off, every
direction, a fifth of them near or exactly vertical or horizontal),
"border" lines along the image border and columns on it, "cell
boundaries" columns on the cells' boundaries and lines along them whose
band's edge falls on a boundary or a column (the gate's strict <),
"non-finite" NaN and infinite line coefficients, coordinates and sigma2
and a few columns past 2^20 px, "one cell" lines through a 0.5 px
square of columns, "empty windows" lines that miss the image and
degenerate lines (l0 = l1 = 0: none or, with l2 = 0, every column),
"no gated pair" every third line moved 1000 px off and "wide windows"
sigma2 400 times larger.
"""
import numpy as np
import torch

import airdos_tpu_torch.ops.match_kernels as mk

MODES = ("motion", "local", "stereo", "bow", "fuse", "epipolar")
CASES = ("path", "border", "cell boundaries", "non-finite", "one cell",
         "empty windows", "no gated pair", "wide windows")
W, H, LEVELS = 640.0, 360.0, 8
F32 = np.float32


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _flip(rng, d):
    """A few bits of each descriptor flipped."""
    flips = rng.integers(0, 32, d.shape).astype(np.uint32)
    return d ^ np.where(rng.uniform(size=d.shape) < 0.3,
                        np.left_shift(np.uint32(1), flips),
                        np.uint32(0)).astype(np.uint32)


def _columns(rng, N):
    cd = _words(rng, (N, 8))
    cd[N // 2::7] = cd[N // 2 - 1::7][:len(cd[N // 2::7])]   # duplicates
    return dict(desc=cd, key=rng.integers(0, LEVELS, N),
                ok=rng.uniform(size=N) < 0.95,
                x=rng.uniform(0, W, N).astype(F32),
                y=rng.uniform(0, H, N).astype(F32))


def _bad(rng, n, share):
    """A non-finite value (NaN, inf or -inf) where a draw < share, else 0
    (added to a coordinate)."""
    pick = rng.uniform(size=n) < share
    return np.where(pick, rng.choice([np.nan, np.inf, -np.inf], n),
                    0).astype(F32)


def make(mode: int, case: str, rng, P: int, N: int, B: int = 1) -> dict:
    """One case of mode (mk.MOTION .. mk.EPIPOLAR); B targets in fuse and
    epipolar mode."""
    if mode == mk.FUSE:
        return _fuse(case, rng, P, N, B)
    if mode == mk.EPIPOLAR:
        return _epipolar(case, rng, P, N, B)
    c = _columns(rng, N)
    src = rng.integers(0, N, P)
    derived = rng.uniform(size=P) < 0.7
    rd = _flip(rng, np.where(derived[:, None], c["desc"][src],
                             _words(rng, (P, 8))))
    rk = np.clip(c["key"][src] + rng.integers(-1, 2, P), 0, LEVELS - 1)
    rows = dict(desc=rd, key=rk, ok=rng.uniform(size=P) < 0.9)
    out = dict(mode=mode, rows=rows, cols=c, th=100, ratio=0.0,
               band=(None, None), max_d=0.0, resolve=False, angles=None,
               sigma2=None)
    if mode == mk.BOW:
        c["key"] = rng.integers(-1, 12, N)
        rows["key"] = np.where(derived, c["key"][src], rng.integers(-1, 12, P))
        if case == "one cell":
            c["key"][:] = 5
            rows["key"][:] = np.where(rng.uniform(size=P) < 0.8, 5, -1)
        elif case == "empty windows":
            rows["key"] = rng.integers(20, 30, P)
        elif case == "no gated pair":
            rows["key"][::3] = 99
        elif case == "wide windows":
            c["key"] = rng.integers(0, 3, N)
            rows["key"] = rng.integers(0, 3, P)
        del c["x"], c["y"]
        ang = rng.uniform(0, 360, P).astype(F32)
        tab = rng.uniform(0, 360, N).astype(F32)
        tab[src[:P // 2]] = (ang[:P // 2] - 10) % 360        # a dominant bin
        out.update(th=49, ratio=0.7, resolve=True, angles=(ang, tab))
        return out
    if mode == mk.STEREO:
        rows["x"] = (c["x"][src] + rng.uniform(0, 60, P)).astype(F32)
        rows["y"] = (c["y"][src] + rng.uniform(-2, 2, P)).astype(F32)
        c["w"] = (2.0 * 1.2 ** c["key"]).astype(F32)
        out.update(th=74, ratio=0.9, max_d=100.0)
    else:
        rows["x"] = (c["x"][src] + rng.normal(0, 3, P)).astype(F32)
        rows["y"] = (c["y"][src] + rng.normal(0, 3, P)).astype(F32)
        c["w"] = np.where(rng.uniform(size=N) < 0.7,
                          c["x"] - rng.uniform(1, 40, N), -1).astype(F32)
        c["taken"] = rng.uniform(size=N) < 0.1
        rows["ur"] = (rows["x"] - rng.uniform(1, 40, P)).astype(F32)
        rows["radius"] = (7.0 * 1.2 ** rk).astype(F32)
        if mode == mk.LOCAL:
            out.update(ratio=0.8, band=(-1, 0), resolve=True)
        else:
            out.update(band=[(0, None), (None, 0), (-1, 1)][P % 3],
                       resolve=True)
            ang = rng.uniform(0, 360, P).astype(F32)
            tab = rng.uniform(0, 360, N).astype(F32)
            tab[src[:P // 2]] = (ang[:P // 2] - 10) % 360
            out["angles"] = (ang, tab)
    _edges(case, rng, out, rows, c)
    return out


def _edges(case, rng, out, rows, c):
    """The grid's edge cases on a geometric mode's rows and columns (fuse:
    one target's, [P] and [N])."""
    P, N = len(rows["x"]), len(c["x"])
    stereo = out["mode"] == mk.STEREO
    if case == "border":
        k = rng.uniform(size=P) < 0.4
        rows["x"][k] = rng.choice(F32([-5, 0, 3, W - 2, W, W + 6]), k.sum())
        rows["y"][k] = rng.choice(F32([-3, 0, 2, H - 1, H, H + 4]), k.sum())
        j = rng.uniform(size=N) < 0.3
        c["x"][j] = rng.choice(F32([0, 0.5, W - 0.01, W]), j.sum())
        c["y"][j] = rng.choice(F32([0, 0.5, H - 0.01, H]), j.sum())
    elif case == "cell boundaries":
        c["x"][:] = F32(10) * rng.integers(0, 65, N).astype(F32)
        c["y"][:] = F32(7.5) * rng.integers(0, 49, N).astype(F32)
        c["x"][:2], c["y"][:2] = F32([0, W]), F32([0, H])  # the extent
        src = rng.integers(0, N, P)
        if stereo:
            rows["x"][:] = c["x"][src] + F32(10) * rng.integers(0, 5, P)
            rows["y"][:] = c["y"][src] + F32(7.5) * rng.integers(-1, 2, P)
            c["w"][:] = F32(7.5)
            out["max_d"] = 40.0
        else:
            r = rng.choice(F32([5, 7.5, 10, 15]), P)
            rows["radius"][:] = r
            rows["x"][:] = c["x"][src] + r * rng.choice(F32([-1, 0, 1]), P)
            rows["y"][:] = c["y"][src] + r * rng.choice(F32([-1, 0, 1]), P)
    elif case == "non-finite":
        rows["x"] += _bad(rng, P, 0.1)
        rows["y"] += _bad(rng, P, 0.1)
        c["x"] += _bad(rng, N, 0.1)
        c["y"] += _bad(rng, N, 0.1)
        c["w"] += _bad(rng, N, 0.1)
        if "radius" in rows:
            rows["radius"] += _bad(rng, P, 0.1)
            rows["ur"] += _bad(rng, P, 0.1)
    elif case == "one cell":
        c["x"][:] = F32(300) + rng.uniform(0, 0.5, N).astype(F32)
        c["y"][:] = F32(200) + rng.uniform(0, 0.4, N).astype(F32)
        rows["x"][:] = F32(300) + rng.uniform(-3, 3, P).astype(F32)
        rows["y"][:] = F32(200) + rng.uniform(-3, 3, P).astype(F32)
        if stereo:
            rows["x"] += F32(2)
    elif case == "empty windows":
        if stereo:
            rows["x"][::2] = F32(-50)
            out["max_d"] = 3.0
        else:
            rows["radius"][::2] = rng.choice(F32([0, -1, -7]), len(rows["x"][::2]))
            rows["x"][1::2] = F32(2000)
    elif case == "no gated pair":
        rows["key"][::3] = 40
    elif case == "wide windows":
        if stereo:
            c["w"][:] = F32(30)
            c["key"][:] = 0
            rows["key"][:] = 0
            out["max_d"] = 640.0
            rows["x"][:] = rows["x"] + F32(200)
        else:
            rows["radius"][:] = F32(100)


def _fuse(case, rng, P, N, B):
    cols = [_columns(rng, N) for _ in range(B)]
    for c in cols:
        c["w"] = np.where(rng.uniform(size=N) < 0.7,
                          c["x"] - rng.uniform(1, 40, N), -1).astype(F32)
    desc_p = _words(rng, (P, 8))
    rows = dict(key=np.zeros((B, P), np.int64), ok=np.zeros((B, P), bool),
                x=np.zeros((B, P), F32), y=np.zeros((B, P), F32),
                ur=np.zeros((B, P), F32), radius=np.zeros((B, P), F32))
    src = rng.integers(0, N, P)
    derived = rng.uniform(size=P) < 0.7
    desc_p = _flip(rng, np.where(derived[:, None], cols[0]["desc"][src], desc_p))
    scales = (1.2 ** np.arange(LEVELS)).astype(F32)
    for b, c in enumerate(cols):
        s = rng.integers(0, N, P) if b else src
        r = dict(x=(c["x"][s] + rng.normal(0, 1.5, P)).astype(F32),
                 y=(c["y"][s] + rng.normal(0, 1.5, P)).astype(F32),
                 key=np.clip(c["key"][s] + rng.integers(-1, 2, P), 0,
                             LEVELS - 1))
        r["ur"] = (r["x"] - np.where(c["w"][s] >= 0, c["x"][s] - c["w"][s],
                                     rng.uniform(1, 40, P))
                   + rng.normal(0, 1, P)).astype(F32)
        r["radius"] = (F32(3.0) * scales[r["key"]]).astype(F32)
        r["ok"] = rng.uniform(size=P) < 0.6
        out = dict(mode=mk.FUSE)
        _edges(case, rng, out, r, c)
        for k in rows:
            rows[k][b] = r[k]
    rows["desc"] = desc_p
    stack = {k: np.stack([c[k] for c in cols]) for k in cols[0]}
    return dict(mode=mk.FUSE, rows=rows, cols=stack, th=50, ratio=0.0,
                band=(None, None), max_d=0.0, resolve=False, angles=None,
                sigma2=(scales * scales).astype(F32))


def _line_through(x, y, theta, scale, off):
    """Lines (l0, l1, l2) of normal scale * (cos, sin) theta at signed
    distance off (px) from the points (x, y), float32 [n, 3]."""
    l0, l1 = scale * np.cos(theta), scale * np.sin(theta)
    l2 = -(l0 * x + l1 * y) + off * scale
    return np.stack(np.broadcast_arrays(l0, l1, l2), -1).astype(F32)


def _epipolar(case, rng, P, N, B):
    scales = (1.2 ** np.arange(LEVELS)).astype(F32)
    sigma2 = (scales * scales).astype(F32)
    if case == "wide windows":
        sigma2 = (sigma2 * F32(400)).astype(F32)
    cols = [_columns(rng, N) for _ in range(B)]
    base = _words(rng, (P, 8))
    derived = rng.uniform(size=P) < 0.7
    line = np.zeros((B, P, 3), F32)
    for b, c in enumerate(cols):
        _epipolar_columns(case, rng, c)
        src = rng.integers(0, N, P)
        c["desc"][src[derived]] = _flip(rng, base[derived])
        theta = rng.uniform(0, 2 * np.pi, P)
        near = rng.uniform(size=P)
        tiny = 10.0 ** rng.uniform(-9, -3, P)
        theta = np.where(near < 0.05, 0.0, np.where(
            near < 0.1, np.pi / 2, np.where(near < 0.15, tiny, np.where(
                near < 0.2, np.pi / 2 + tiny, theta))))
        scale = 10.0 ** rng.uniform(-5, 0, P)
        line[b] = _line_through(c["x"][src].astype(np.float64),
                                c["y"][src].astype(np.float64), theta, scale,
                                rng.normal(0, 1.5, P))
        c["w"] = sigma2[c["key"]]
        _epipolar_lines(case, rng, line[b], c, sigma2)
    rows = dict(desc=_flip(rng, base), key=rng.integers(0, LEVELS, P),
                ok=rng.uniform(size=P) < 0.9, line=line)
    stack = {k: np.stack([c[k] for c in cols]) for k in cols[0]}
    return dict(mode=mk.EPIPOLAR, rows=rows, cols=stack, th=49, ratio=0.0,
                band=(None, None), max_d=0.0, resolve=False, angles=None,
                sigma2=None)


def _epipolar_columns(case, rng, c):
    """The grid's edge cases on one target's column positions."""
    N = len(c["x"])
    if case == "border":
        j = rng.uniform(size=N) < 0.3
        c["x"][j] = rng.choice(F32([0, 0.5, W - 0.01, W]), j.sum())
        c["y"][j] = rng.choice(F32([0, 0.5, H - 0.01, H]), j.sum())
    elif case == "cell boundaries":
        c["x"][:] = F32(10) * rng.integers(0, 65, N).astype(F32)
        c["y"][:] = F32(7.5) * rng.integers(0, 49, N).astype(F32)
        c["x"][:2], c["y"][:2] = F32([0, W]), F32([0, H])   # the extent
    elif case == "one cell":
        c["x"][:] = F32(300) + rng.uniform(0, 0.5, N).astype(F32)
        c["y"][:] = F32(200) + rng.uniform(0, 0.4, N).astype(F32)


def _epipolar_lines(case, rng, line, c, sigma2):
    """The grid's edge cases on one target's lines [P, 3] (and, non-finite,
    its columns)."""
    P, N = len(line), len(c["x"])
    k = rng.uniform(size=P) < 0.5
    n = int(k.sum())
    scale = 10.0 ** rng.uniform(-4, 0, n)
    if case == "border":
        vertical = rng.uniform(size=n) < 0.5
        at = np.where(vertical, rng.choice([0.0, W, -2.0, W + 3], n),
                      rng.choice([0.0, H, -2.0, H + 3], n))
        theta = np.where(vertical, 0.0, np.pi / 2)
        line[k] = _line_through(np.where(vertical, at, 0), np.where(
            vertical, 0, at), theta, scale, 0.0)
    elif case == "cell boundaries":
        # vertical and horizontal lines whose band ends on a boundary or
        # on a column, and diagonals through the cells' corners
        half = np.sqrt(3.84 * sigma2[rng.integers(0, LEVELS, n)])
        kind = rng.integers(0, 3, n)
        gx = 10.0 * rng.integers(0, 65, n)
        gy = 7.5 * rng.integers(0, 49, n)
        off = rng.choice([-1.0, 0.0, 1.0], n) * half
        line[k] = np.where(
            (kind == 0)[:, None], _line_through(gx, 0, 0.0, scale, off),
            np.where((kind == 1)[:, None],
                     _line_through(0, gy, np.pi / 2, scale, off),
                     _line_through(gx, gy, rng.choice(
                         [np.pi / 4, 3 * np.pi / 4, np.arctan2(7.5, 10)], n),
                         scale, off)))
    elif case == "non-finite":
        bad = rng.uniform(size=(P, 3)) < 0.05
        line[bad] = rng.choice(F32([np.nan, np.inf, -np.inf]), bad.sum())
        c["x"] += _bad(rng, N, 0.1)
        c["y"] += _bad(rng, N, 0.1)
        c["w"] = (c["w"] + _bad(rng, N, 0.1)).astype(F32)
        far = rng.choice(N, 3, replace=False)
        c["x"][far] = F32(3e6)
    elif case == "one cell":
        line[:] = _line_through(np.full(P, 300.25), np.full(P, 200.2),
                                rng.uniform(0, 2 * np.pi, P),
                                10.0 ** rng.uniform(-4, 0, P),
                                rng.normal(0, 2, P))
    elif case == "empty windows":
        off = rng.choice([1e4, -1e5, 3e7], n)
        line[k] = _line_through(rng.uniform(0, W, n), rng.uniform(0, H, n),
                                rng.uniform(0, 2 * np.pi, n), scale, off)
        z = rng.choice(P, 4, replace=False)
        line[z] = F32([[0, 0, 1e-3], [0, 0, 0], [0, 0, -5], [1e-9, 0, 0]])
    elif case == "no gated pair":
        line[::3] = _line_through(np.zeros(len(line[::3])), 0.0, np.pi / 4,
                                  1.0, 1000.0)


def args(c: dict, device="cpu") -> tuple:
    """match_rows' positional arguments for case c on device."""
    def t(a):
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)

    r, k = c["rows"], c["cols"]
    rows = mk.MatchRows(t(r["desc"]), t(r["key"]), t(r["ok"]), t(r.get("x")),
                        t(r.get("y")), t(r.get("ur")), t(r.get("radius")),
                        t(r.get("line")))
    cols = mk.MatchCols(t(k["desc"]), t(k["key"]), t(k["ok"]), t(k.get("x")),
                        t(k.get("y")), t(k.get("w")), t(k.get("taken")))
    angles = None if c["angles"] is None else tuple(map(t, c["angles"]))
    return (c["mode"], rows, cols, c["th"], c["ratio"], c["band"],
            c["max_d"], c["resolve"], angles, t(c["sigma2"]))
