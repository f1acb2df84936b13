"""A torch emulation of csrc/sim3_edges.cu's forward-mode edge system, for
the CPU tests: the kernel's steps, in its order of operations and with its
branches, on dual numbers (a value [E] and the 14 directions' tangents
[E, 14] side by side; the kernel's lane d carries tangent d alone, and
forward mode is linear in the tangent, so the columns are the lanes').
The branches are chosen per edge by the value, as every lane of an edge
chooses them, with torch.where over both halves of the dual number (an
untaken branch's NaN never reaches the result).  This checks the
kernel's algorithm, not its float32 rounding (nvcc may contract)."""
from __future__ import annotations

import torch

N_DIRS = 14
EPS = 1e-8


class Dual:
    def __init__(self, v, d=None):
        self.v = v
        self.d = torch.zeros(v.shape + (N_DIRS,), dtype=v.dtype) \
            if d is None else d

    def __add__(self, o):
        o = _dual(o, self)
        return Dual(self.v + o.v, self.d + o.d)

    __radd__ = __add__

    def __sub__(self, o):
        o = _dual(o, self)
        return Dual(self.v - o.v, self.d - o.d)

    def __rsub__(self, o):
        return _dual(o, self) - self

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        o = _dual(o, self)
        return Dual(self.v * o.v, self.d * o.v[..., None]
                    + self.v[..., None] * o.d)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = _dual(o, self)
        q = self.v / o.v
        return Dual(q, (self.d - q[..., None] * o.d) / o.v[..., None])

    def __rtruediv__(self, o):
        return _dual(o, self) / self


def _dual(x, like):
    """x as a dual number of like's shape (a constant: zero tangents)."""
    if isinstance(x, Dual):
        return x
    if torch.is_tensor(x):
        return Dual(x.expand_as(like.v).clone())
    return Dual(torch.full_like(like.v, float(x)))


def where(c, a, b):
    like = a if isinstance(a, Dual) else b
    a, b = _dual(a, like), _dual(b, like)
    return Dual(torch.where(c, a.v, b.v), torch.where(c[..., None], a.d, b.d))


def dsqrt(a):
    r = torch.sqrt(a.v)
    return Dual(r, a.d / (2.0 * r)[..., None])


def dsin(a):
    return Dual(torch.sin(a.v), torch.cos(a.v)[..., None] * a.d)


def dcos(a):
    return Dual(torch.cos(a.v), -torch.sin(a.v)[..., None] * a.d)


def dexp(a):
    e = torch.exp(a.v)
    return Dual(e, e[..., None] * a.d)


def dlog(a):
    return Dual(torch.log(a.v), a.d / a.v[..., None])


def datan2(y, x):
    n = x.v * x.v + y.v * y.v
    return Dual(torch.atan2(y.v, x.v),
                (x.v[..., None] * y.d - y.v[..., None] * x.d) / n[..., None])


def dmax(a, lo):
    return where(a.v >= lo, a, lo)


def dmin(a, hi):
    return where(a.v <= hi, a, hi)


def matmul3(A, B):
    return [A[r * 3] * B[c] + A[r * 3 + 1] * B[3 + c] + A[r * 3 + 2] * B[6 + c]
            for r in range(3) for c in range(3)]


def matvec3(A, x):
    return [A[r * 3] * x[0] + A[r * 3 + 1] * x[1] + A[r * 3 + 2] * x[2]
            for r in range(3)]


def so3_log(R):
    trace = R[0] + R[4] + R[8]
    cos_t = dmin(dmax(0.5 * (trace - 1.0), -1.0), 1.0)
    v = [R[7] - R[5], R[2] - R[6], R[3] - R[1]]
    vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    sin_t_n = 0.5 * dsqrt(dmax(vv, 1e-12))
    theta = datan2(sin_t_n, cos_t)
    sin_t = dsin(theta)
    small = torch.abs(sin_t.v) < 1e-6
    near_pi = cos_t.v < -0.999
    one = torch.ones_like(sin_t.v)
    scale = where(small, 0.5 + (theta * theta) / 12.0,
                  theta / (2.0 * where(small, one, sin_t)))
    w_gen = [scale * v[k] for k in range(3)]
    den = dmax(1.0 - cos_t, 1e-12)
    axis = [dsqrt(dmax(dmax((R[4 * k] - cos_t) / den, 0.0), 1e-12))
            for k in range(3)]
    av = torch.stack([a.v for a in axis], -1)
    kmax = torch.argmax(av, dim=-1)
    sign = torch.stack([torch.where(x.v >= 0, 1.0, -1.0) for x in v], -1)
    ref = torch.gather(sign, -1, kmax[:, None])[:, 0]
    axis = [Dual(ref, torch.zeros_like(axis[k].d)) *
            (Dual(sign[:, k], torch.zeros_like(axis[k].d)) * axis[k])
            for k in range(3)]
    nrm = dmax(dsqrt(axis[0] * axis[0] + axis[1] * axis[1]
                     + axis[2] * axis[2]), 1e-12)
    w_pi = [(axis[k] / nrm) * theta for k in range(3)]
    return [where(near_pi, w_pi[k], w_gen[k]) for k in range(3)]


def sim3_V(w, sigma):
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = dsqrt(theta2 + EPS * EPS)
    small_s = torch.abs(sigma.v) < 1e-6
    small_t = theta2.v < 1e-8
    one = torch.ones_like(sigma.v)
    sig = where(small_s, one, sigma)
    th2 = where(small_t, one, theta2)
    a = where(small_s & small_t, one, sigma * sigma + theta2)
    s = dexp(sigma)
    c1 = (s - 1.0) / sig
    s_cos = s * dcos(theta)
    s_sin = s * dsin(theta)
    B_gen = (sigma * s_sin + theta * (1.0 - s_cos)) / (theta * a)
    C_gen = (c1 - ((s_cos - 1.0) * sigma + s_sin * theta) / a) / th2
    B_se3 = where(small_t, 0.5 - theta2 / 24.0,
                  (1.0 - dcos(theta)) / (theta2 + EPS))
    C_se3 = where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - dsin(theta)) / (theta2 * theta + EPS))
    B_sig = ((sigma - 1.0) * s + 1.0) / (sig * sig)
    A = where(small_s, one, c1)
    B = where(small_s, B_se3, where(small_t, B_sig, B_gen))
    C = where(small_s, C_se3, where(small_t, 0.0 * one, C_gen))
    zero = Dual(torch.zeros_like(sigma.v))
    W = [zero, -w[2], w[1], w[2], zero, -w[0], -w[1], w[0], zero]
    W2 = matmul3(W, W)
    V = [B * W[j] + C * W2[j] for j in range(9)]
    for j in (0, 4, 8):
        V[j] = A + V[j]
    return V


def edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    Rinv = [Rj[c * 3 + r] for r in range(3) for c in range(3)]
    sinv = 1.0 / sj
    Rt = matvec3(Rinv, tj)
    tinv = [(-sinv) * Rt[k] for k in range(3)]
    Rij = matmul3(Ri, Rinv)
    q = matvec3(Ri, tinv)
    tij = [si * q[k] + ti[k] for k in range(3)]
    sij = si * sinv
    Re = matmul3(Rm, Rij)
    q = matvec3(Rm, tij)
    te = [sm * q[k] + tm[k] for k in range(3)]
    se = sm * sij
    w = so3_log(Re)
    sigma = dlog(se)
    V = sim3_V(w, sigma)
    a, b, c, d, f, g, h, k, l = (x.v for x in V)
    inv = [f * l - g * k, -(b * l - c * k), b * g - c * f,
           -(d * l - g * h), a * l - c * h, -(a * g - c * d),
           d * k - f * h, -(a * k - b * h), a * f - b * d]
    inv_det = 1.0 / (a * inv[0] + b * inv[3] + c * inv[6])
    vv = [(inv[r * 3] * te[0].v + inv[r * 3 + 1] * te[1].v
           + inv[r * 3 + 2] * te[2].v) * inv_det for r in range(3)]
    rhs = [te[r].d - (V[r * 3].d * vv[0][:, None]
                      + V[r * 3 + 1].d * vv[1][:, None]
                      + V[r * 3 + 2].d * vv[2][:, None]) for r in range(3)]
    e = [Dual(vv[r], (inv[r * 3][:, None] * rhs[0]
                      + inv[r * 3 + 1][:, None] * rhs[1]
                      + inv[r * 3 + 2][:, None] * rhs[2]) * inv_det[:, None])
         for r in range(3)]
    return e + w + [sigma]


def edge_system(R, t, s, e_i, e_j, Rm, tm, sm):
    """(e [E, 7], J [E, 7, 14]) of every edge as the kernel's lanes take
    them: vertex i's 7 directions then vertex j's (t, rotation, scale)."""
    E = e_i.shape[0]
    sides = []
    for side, v in enumerate((e_i.long(), e_j.long())):
        Rv, tv, sv = R[v].reshape(E, 9), t[v], s[v]
        dR = torch.zeros((E, 9, N_DIRS), dtype=R.dtype)
        for a in range(3):       # hat(e_a) R, direction 7 side + 3 + a
            col = 7 * side + 3 + a
            for c in range(3):
                if a == 0:
                    dR[:, 3 + c, col], dR[:, 6 + c, col] = \
                        -Rv[:, 6 + c], Rv[:, 3 + c]
                elif a == 1:
                    dR[:, c, col], dR[:, 6 + c, col] = Rv[:, 6 + c], -Rv[:, c]
                else:
                    dR[:, c, col], dR[:, 3 + c, col] = -Rv[:, 3 + c], Rv[:, c]
        Rd = [Dual(Rv[:, j], dR[:, j]) for j in range(9)]
        td = []
        for c in range(3):
            d = torch.zeros((E, N_DIRS), dtype=R.dtype)
            d[:, 7 * side + c] = 1.0
            td.append(Dual(tv[:, c], d))
        ds = torch.zeros((E, N_DIRS), dtype=R.dtype)
        ds[:, 7 * side + 6] = sv
        sides.append((Rd, td, Dual(sv, ds)))
    Rmd = [Dual(Rm.reshape(E, 9)[:, j]) for j in range(9)]
    tmd = [Dual(tm[:, c]) for c in range(3)]
    e = edge_residual(*sides[0], *sides[1], Rmd, tmd, Dual(sm))
    return torch.stack([x.v for x in e], -1), torch.stack([x.d for x in e], 1)
