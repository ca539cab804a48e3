"""Batched factor updates — the GBP hot path (counterpart of magics_tpu's
graph/factors.py, whose docstrings derive the maths).

Each function updates all factors of one kind for all robots as dense tensor
ops: the dynamic, obstacle ("gather" taps) and tracking messages, the
inter-robot messages of the three exchanges (the dense 8x8 form, the rank-1
form of "sender" and "receiver", the compact form of "receiver_compact")
and the rank-1 helpers.
"""

from __future__ import annotations

import torch

from benchmark.reference.linalg import (
    inv4_rowscaled,
    marginalize_two_block,
    mm,
    mtm,
    mv,
)


def _eye2(dtype, device):
    return torch.eye(2, dtype=dtype, device=device)


def dynamic_factor_messages(
    v2f_eta: torch.Tensor,   # [..., 2, 4]
    v2f_lam: torch.Tensor,   # [..., 2, 4, 4]
    v2f_mu: torch.Tensor,    # [..., 2, 4]
    delta_t: torch.Tensor,   # [...]
    sigma: float,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Messages from all dynamic (constant-velocity) factors, in the
    cancellation-free form (magics_tpu factors.py:dynamic_factor_messages):

        msg to b (cavity C, eta_c on a):  S_b = Q^-1 Phi (Phi^T Q^-1 Phi + C)^-1,
                                          lam = S_b C Phi^-1, eta = S_b eta_c
        msg to a (cavity D, eta_d on b):  S_a = Phi^T Q^-1 (Q^-1 + D)^-1,
                                          lam = S_a D Phi,    eta = S_a eta_d

    Returns (f2v_eta [..., 2, 4], f2v_lam [..., 2, 4, 4]); non-finite
    entries are zeroed.
    """
    dev = v2f_eta.device
    batch = delta_t.shape
    eye2 = _eye2(dtype, dev)

    inv_s2 = 1.0 / (sigma * sigma)
    dt = delta_t.to(dtype)
    q11 = (12.0 * inv_s2) / (dt * dt * dt)
    q12 = (-6.0 * inv_s2) / (dt * dt)
    q22 = (4.0 * inv_s2) / dt

    def blk(s):  # [...] -> [..., 2, 2]
        return s[..., None, None] * eye2

    def block2(a, b, c, d):  # 2x2 blocks -> [..., 4, 4]
        return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)

    qinv = block2(blk(q11), blk(q12), blk(q12), blk(q22))
    dtb = dt[..., None, None] * eye2
    eye2b = eye2.expand(batch + (2, 2))
    zero2b = torch.zeros_like(eye2b)
    phi = block2(eye2b, dtb, zero2b, eye2b)
    phi_inv = block2(eye2b, -dtb, zero2b, eye2b)

    qinv_phi = mm(qinv, phi)
    m_aa = mtm(phi, qinv_phi)  # Phi^T Q^-1 Phi

    cav_a_eta = v2f_eta[..., 0, :]
    cav_a_lam = v2f_lam[..., 0, :, :]
    cav_b_eta = v2f_eta[..., 1, :]
    cav_b_lam = v2f_lam[..., 1, :, :]

    # message to var i+1 (slot 1), cavity on var i
    t_b, _ = inv4_rowscaled(m_aa + cav_a_lam)
    s_b = mm(qinv_phi, t_b)
    m1_lam = mm(s_b, mm(cav_a_lam, phi_inv))
    m1_eta = mv(s_b, cav_a_eta)

    # message to var i (slot 0), cavity on var i+1
    t_a, _ = inv4_rowscaled(qinv + cav_b_lam)
    s_a = mm(qinv_phi.transpose(-1, -2), t_a)
    m0_lam = mm(s_a, mm(cav_b_lam, phi))
    m0_eta = mv(s_a, cav_b_eta)

    m0_lam = 0.5 * (m0_lam + m0_lam.transpose(-1, -2))
    m1_lam = 0.5 * (m1_lam + m1_lam.transpose(-1, -2))

    f2v_eta = torch.stack([m0_eta, m1_eta], dim=-2)
    f2v_lam = torch.stack([m0_lam, m1_lam], dim=-3)
    return (
        torch.where(torch.isfinite(f2v_eta), f2v_eta, torch.zeros_like(f2v_eta)),
        torch.where(torch.isfinite(f2v_lam), f2v_lam, torch.zeros_like(f2v_lam)),
    )


def obstacle_delta(sdf_shape: tuple[int, int], world_size: tuple[float, float]) -> float:
    """Finite-difference step = mean pixel size (obstacle.rs:98-102)."""
    H, W = sdf_shape
    ww, wh = world_size
    return (ww / W + wh / H) / 2.0


def obstacle_taps(
    v2f_mu: torch.Tensor,     # [..., 4]
    sdf: torch.Tensor,        # [H, W] in [0, 1]
    world_size: tuple[float, float],
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three SDF samples (h0, h(+dx), h(+dy)) each obstacle factor needs,
    by direct indexing (the JAX "gather" method): world -> pixel with a
    truncating, negative-saturating cast; 0 past the image edge."""
    H, W = sdf.shape
    ww, wh = world_size
    x_scale = W / ww
    y_scale = H / wh
    delta = obstacle_delta((H, W), world_size)
    zero = torch.zeros((), dtype=dtype, device=sdf.device)

    def measure(px, py):
        xf = (px + ww / 2.0) * x_scale
        yf = (-py + wh / 2.0) * y_scale
        xi = torch.floor(xf.clamp(min=0.0)).clamp(0, W - 1).long()
        yi = torch.floor(yf.clamp(min=0.0)).clamp(0, H - 1).long()
        inside = (xf < W) & (yf < H)
        val = 1.0 - sdf[yi, xi]
        return torch.where(inside, val, zero).to(dtype)

    px = v2f_mu[..., 0]
    py = v2f_mu[..., 1]
    return measure(px, py), measure(px + delta, py), measure(px, py + delta)


def obstacle_messages_from_taps(
    h0: torch.Tensor,        # [...]
    hx: torch.Tensor,
    hy: torch.Tensor,
    v2f_mu: torch.Tensor,    # [..., 4]
    delta: float,
    sigma: float,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Obstacle factor message arithmetic given the SDF taps: the unary
    potential J^T lam_m (J x0 - h0), lam_m J J^T with J = (jx, jy, 0, 0)."""
    jx = (hx - h0) / delta
    jy = (hy - h0) / delta
    z = torch.zeros_like(jx)
    J = torch.stack([jx, jy, z, z], dim=-1)
    lam_m = 1.0 / (sigma * sigma)
    jx0 = (J * v2f_mu.to(dtype)).sum(dim=-1)
    eta_f = J * (lam_m * (jx0 - h0))[..., None]
    lam_f = lam_m * J[..., :, None] * J[..., None, :]
    return eta_f, lam_f


def _interrobot_measurement(
    d_raw: torch.Tensor,            # [..., 2] internal minus external position
    safety_distance: torch.Tensor,  # [...]
    tiny_offset: torch.Tensor,      # [...]
    dtype: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The inter-robot measurement shared by every exchange
    (interrobot.rs:40-237): the skip flag (raw squared distance >= d_safe^2,
    interrobot.rs:213-226), h0 = 1 - r/d_safe within the safety distance
    (else 0) and J's position block g on the internal variable, with r taken
    from d_raw plus the per-factor tiny offset (interrobot.rs:91-106).
    Returns (skipped, h0, g [..., 2])."""
    dist2_raw = (d_raw * d_raw).sum(dim=-1)
    skipped = dist2_raw >= safety_distance * safety_distance

    diff = d_raw + tiny_offset[..., None]
    r = torch.sqrt((diff * diff).sum(dim=-1))
    within = r <= safety_distance

    h0 = torch.where(within, 1.0 - r / safety_distance, torch.zeros_like(r)).to(dtype)
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    g2 = torch.where(
        within[..., None],
        -diff / (safety_distance[..., None] * safe_r[..., None]),
        torch.zeros_like(diff),
    ).to(dtype)
    return skipped, h0, g2


def interrobot_factor_messages(
    x_int: torch.Tensor,        # [..., 4] linearisation mean of the internal variable
    x_ext: torch.Tensor,        # [..., 4] linearisation mean of the external variable
    v2f_int_eta: torch.Tensor,  # [..., 4]
    v2f_int_lam: torch.Tensor,  # [..., 4, 4]
    v2f_ext_eta: torch.Tensor,  # [..., 4]
    v2f_ext_lam: torch.Tensor,  # [..., 4, 4]
    safety_distance: torch.Tensor,  # [...]
    tiny_offset: torch.Tensor,      # [...]
    sigma: float,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, ...]:
    """Messages from all inter-robot collision factors in the dense 8x8 form
    (magics_tpu factors.py:interrobot_factor_messages): the potential
    J^T Lam_m J with J = [g, 0, -g, 0] over (internal, external), each edge's
    message the two-block Schur marginal with the other edge's cavity added.
    Skipped factors emit empty messages.

    Returns (f2v_int_eta, f2v_int_lam, f2v_ext_eta, f2v_ext_lam, skipped).
    The exchanges send only the external message, in the rank-1 form below;
    this form is the reference the tests hold that one against."""
    skipped, h0, g = _interrobot_measurement(
        x_int[..., :2] - x_ext[..., :2], safety_distance, tiny_offset, dtype
    )
    zero2 = torch.zeros_like(g)
    J = torch.cat([g, zero2, -g, zero2], dim=-1)  # [..., 8]

    lam_m = 1.0 / (sigma * sigma)
    x0 = torch.cat([x_int, x_ext], dim=-1).to(dtype)
    jx0 = (J * x0).sum(dim=-1)
    eta_f = J * (lam_m * (jx0 - h0))[..., None]
    lam_f = lam_m * J[..., :, None] * J[..., None, :]

    laa, lab = lam_f[..., :4, :4], lam_f[..., :4, 4:]
    lba, lbb = lam_f[..., 4:, :4], lam_f[..., 4:, 4:]
    eta_a, eta_b = eta_f[..., :4], eta_f[..., 4:]

    # message to the internal variable (block a); other edge = external
    int_eta, int_lam, _ = marginalize_two_block(
        eta_a, eta_b + v2f_ext_eta, laa, lab, lba, lbb + v2f_ext_lam
    )
    # message to the external variable (block b); other edge = internal
    ext_eta, ext_lam, _ = marginalize_two_block(
        eta_b, eta_a + v2f_int_eta, lbb, lba, lab, laa + v2f_int_lam
    )

    keep = ~skipped
    k1, k2 = keep[..., None], keep[..., None, None]
    return (
        torch.where(k1, int_eta, torch.zeros_like(int_eta)),
        torch.where(k2, int_lam, torch.zeros_like(int_lam)),
        torch.where(k1, ext_eta, torch.zeros_like(ext_eta)),
        torch.where(k2, ext_lam, torch.zeros_like(ext_lam)),
        skipped,
    )


def interrobot_rank1_messages(
    x_int: torch.Tensor,        # [..., 4] internal linearisation mean (snap mu)
    p_ext: torch.Tensor,        # [..., 2] external variable position
    cav_eta: torch.Tensor,      # [..., 4] internal cavity (snap eta where seeded)
    cav_lam: torch.Tensor,      # [..., 4, 4] internal cavity precision
    safety_distance: torch.Tensor,  # [...]
    tiny_offset: torch.Tensor,      # [...]
    sigma: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Message from each inter-robot factor to its external variable in
    compact rank-1 form [..., (gx, gy, t, s)], eta = g t, lam = s g g^T
    (magics_tpu factors.py:interrobot_rank1_messages, which derives it):

        M = alpha g g^T + cavity,  q = g^T M^-1 g,
        w = g^T M^-1 (alpha g (J x0 - h) + cav_eta),
        s = alpha (1 - alpha q),   t = alpha (w - (J x0 - h))

    Empty on a singular (|det| <= 1e-6 after row scaling), non-finite,
    insane or negligible marginal and on the skip condition. An empty entry
    is a select, not a product with the validity mask: an unseeded cavity
    with g = 0 makes M = 0 and its inverse 0/0, and the JAX function, whose
    jit turns `x * valid` into a select, emits 0 there too."""
    d_raw = x_int[..., :2] - p_ext
    skipped, h0, g2 = _interrobot_measurement(d_raw, safety_distance, tiny_offset, dtype)

    alpha = 1.0 / (sigma * sigma)
    # J x0 = g . p_int - g . p_ext (the velocity columns of J are zero)
    jx0 = (g2 * d_raw.to(dtype)).sum(dim=-1)
    resid = jx0 - h0

    g4 = torch.cat([g2, torch.zeros_like(g2)], dim=-1)
    M = alpha * g4[..., :, None] * g4[..., None, :] + cav_lam
    M_inv, det = inv4_rowscaled(M)
    Mg = mv(M_inv, g4)
    q = (g4 * Mg).sum(dim=-1)
    # w sums its four terms left to right, spelled out: a reduction's order
    # is the backend's, and w cancels (ill-conditioned cavities), so its
    # last bits would differ from one device to another
    wt = Mg * (alpha * resid[..., None] * g4 + cav_eta)
    w = ((wt[..., 0] + wt[..., 1]) + wt[..., 2]) + wt[..., 3]

    s = alpha * (1.0 - alpha * q)
    t = alpha * (w - resid)

    gmax2 = g2.abs().amax(dim=-1) ** 2
    finite = torch.isfinite(s) & torch.isfinite(t)
    sane = s.abs() * gmax2 <= 4.0 * alpha * gmax2 + 1.0
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    negligible = s.abs() * gmax2 <= rtol * alpha * gmax2
    valid = (det.abs() > 1e-6) & finite & sane & ~negligible & ~skipped

    msg = torch.stack([g2[..., 0], g2[..., 1], t, s], dim=-1)
    return torch.where(valid[..., None], msg, torch.zeros_like(msg))


def compact_snap_tables(
    snap_mu: torch.Tensor,   # [R, V, 4]
    snap_eta: torch.Tensor,  # [R, V, 4]
    snap_lam: torch.Tensor,  # [R, V, 4, 4]
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-robot compact cavity tables for the receiver-computes exchange:
    [R, V-1, 8] = (snap_pos 2, mc 2, S 3, valid 1) for variables 1..V-1, with
    S the position block of C^-1 (xx, xy, yy) and mc = (C^-1 eta)[:2]."""
    C_inv, det = inv4_rowscaled(snap_lam[:, 1:])
    finite = torch.isfinite(C_inv).all(dim=-1).all(dim=-1)
    valid = (det.abs() > 1e-6) & finite
    mc = mv(C_inv, snap_eta[:, 1:])[..., :2]
    S = torch.stack([C_inv[..., 0, 0], C_inv[..., 0, 1], C_inv[..., 1, 1]], dim=-1)
    v = valid[..., None]
    return torch.cat(
        [
            snap_mu[:, 1:, :2].to(dtype),
            torch.where(v, mc, torch.zeros_like(mc)).to(dtype),
            torch.where(v, S, torch.zeros_like(S)).to(dtype),
            v.to(dtype),
        ],
        dim=-1,
    )


def interrobot_rank1_messages_compact(
    tables: torch.Tensor,       # [..., 8] gathered compact tables
    seeded: torch.Tensor,       # [...] bool — peer cavity present
    p_ext: torch.Tensor,        # [..., 2] external variable position
    safety_distance: torch.Tensor,  # [...]
    tiny_offset: torch.Tensor,      # [...]
    sigma: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Receiver-computes inter-robot message in compact rank-1 form
    [..., (gx, gy, t, s)] via Sherman-Morrison on the peer's precomputed
    covariance position block:

        u = g^T S g,  den = 1 + alpha u,  s = alpha / den,
        t = alpha (g . mc - (J x0 - h)) / den

    Empty where the cavity is unseeded/invalid, non-finite, negligible or the
    factor is skipped (raw distance >= safety)."""
    snap_pos = tables[..., 0:2]
    mc = tables[..., 2:4]
    Sxx, Sxy, Syy = tables[..., 4], tables[..., 5], tables[..., 6]
    cav_valid = (tables[..., 7] > 0.5) & seeded

    d_raw = snap_pos - p_ext
    skipped, h0, g2 = _interrobot_measurement(d_raw, safety_distance, tiny_offset, dtype)

    alpha = 1.0 / (sigma * sigma)
    jx0 = (g2 * d_raw.to(dtype)).sum(dim=-1)
    resid = jx0 - h0

    gx, gy = g2[..., 0], g2[..., 1]
    u = gx * gx * Sxx + 2.0 * gx * gy * Sxy + gy * gy * Syy
    den = 1.0 + alpha * u
    s = alpha / den
    t = alpha * ((g2 * mc).sum(dim=-1) - resid) / den

    gmax2 = g2.abs().amax(dim=-1) ** 2
    finite = torch.isfinite(s) & torch.isfinite(t)
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    negligible = s.abs() * gmax2 <= rtol * alpha * gmax2
    valid = cav_valid & finite & ~negligible & ~skipped

    ok = valid.to(dtype)
    return torch.stack([gx * ok, gy * ok, t * ok, s * ok], dim=-1)


def rank1_eta_lam(msg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand compact rank-1 messages [..., (gx, gy, t, s)] to information
    form (eta [..., 4], lam [..., 4, 4]); only the position block is
    nonzero."""
    gx, gy, t, s = msg.unbind(dim=-1)
    return _dense_position_block(gx * t, gy * t, s * gx * gx, s * gx * gy, s * gy * gy)


def rank1_sum(msg: torch.Tensor, dim: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum compact rank-1 messages over `dim`, returning dense (eta [..., 4],
    lam [..., 4, 4]) with only the 2x2 position block populated."""
    gx, gy, t, s = msg.unbind(dim=-1)
    return _dense_position_block(
        (gx * t).sum(dim=dim),
        (gy * t).sum(dim=dim),
        (s * gx * gx).sum(dim=dim),
        (s * gx * gy).sum(dim=dim),
        (s * gy * gy).sum(dim=dim),
    )


def _dense_position_block(ex, ey, lxx, lxy, lyy):
    z = torch.zeros_like(ex)
    eta = torch.stack([ex, ey, z, z], dim=-1)
    row0 = torch.stack([lxx, lxy, z, z], dim=-1)
    row1 = torch.stack([lxy, lyy, z, z], dim=-1)
    rowz = torch.stack([z, z, z, z], dim=-1)
    return eta, torch.stack([row0, row1, rowz, rowz], dim=-2)


def tracking_factor_messages(
    v2f_mu: torch.Tensor,      # [R, F, 4]
    path: torch.Tensor,        # [R, W, 2]
    path_len: torch.Tensor,    # [R] i32
    record: torch.Tensor,      # [R, F] i32
    index: torch.Tensor,       # [R] i32 (unused by the maths; kept for parity)
    timeout: torch.Tensor,     # [R, F] i32, -1 = none
    switch_padding: float,
    attraction_distance: float,
    sigma: float,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, ...]:
    """Messages from all tracking (path-following) factors, with the corner
    fix of magics_tpu factors.py:646-710: the projection is clamped to the
    segment, the blend window is capped at half of each adjoining segment,
    and the previous-segment projection must be interior to its segment.

    Returns (f2v_eta, f2v_lam, new_record, new_timeout, last_pos, last_val,
    skipped).
    """
    R, F = record.shape
    Wmax = path.shape[1]

    x_pos = v2f_mu[..., :2]
    x_vel = v2f_mu[..., 2:4]

    plen = path_len[:, None]
    max_record = torch.clamp(plen - 2, min=0)
    rec = torch.minimum(torch.clamp(record, min=0), max_record)

    rows = torch.arange(R, device=path.device)[:, None]

    def gather_pt(idx):  # [R, F] -> [R, F, 2]
        return path[rows, idx.clamp(0, Wmax - 1).long()]

    def norm(x):
        return torch.linalg.vector_norm(x, dim=-1)

    cur_s = gather_pt(rec)
    cur_e = gather_pt(rec + 1)

    line = cur_e - cur_s
    line_dot = (line * line).sum(dim=-1, keepdim=True)
    safe_dot = torch.where(line_dot > 0, line_dot, torch.ones_like(line_dot))
    t_cur = ((x_pos - cur_s) * line).sum(dim=-1, keepdim=True) / safe_dot
    t_cur = t_cur.clamp(0.0, 1.0)
    proj_cur = cur_s + t_cur * line

    d_pad = switch_padding
    d_lo = d_pad * 0.01

    cur_to_end = norm(cur_e - proj_cur)

    prev_s = gather_pt(torch.clamp(rec - 1, min=0))
    prev_e = cur_s
    pline = prev_e - prev_s
    pline_dot = (pline * pline).sum(dim=-1, keepdim=True)
    psafe = torch.where(pline_dot > 0, pline_dot, torch.ones_like(pline_dot))
    t_prev = (((x_pos - prev_s) * pline).sum(dim=-1, keepdim=True) / psafe).clamp(0.0, 1.0)
    proj_prev = prev_s + t_prev * pline

    cur_proj_to_prev_end = norm(prev_e - proj_cur)
    prev_proj_to_prev_end = norm(cur_s - proj_prev)

    prev_len = torch.sqrt(pline_dot[..., 0])
    cur_len = torch.sqrt(line_dot[..., 0])
    win_prev = torch.clamp(0.5 * prev_len, max=d_pad)
    win_cur = torch.clamp(0.5 * cur_len, max=d_pad)
    use_prev = (
        (rec > 0)
        & (cur_proj_to_prev_end < win_cur)
        & (cur_proj_to_prev_end > d_lo)
        & (prev_proj_to_prev_end > d_lo)
        & (prev_proj_to_prev_end < win_prev)
    )

    new_record = torch.where(
        cur_to_end < d_pad, torch.minimum(rec + 1, max_record), rec
    )

    vel_norm = norm(x_vel)[..., None]
    line_norm = norm(line)[..., None]
    line_unit = torch.where(
        line_norm > 0,
        line / torch.where(line_norm > 0, line_norm, torch.ones_like(line_norm)),
        torch.zeros_like(line),
    )
    mp_single = proj_cur + line_unit * vel_norm / 5.0
    mp_blend = x_pos + (proj_cur - x_pos) + (proj_prev - x_pos)
    mp = torch.where(use_prev[..., None], mp_blend, mp_single)

    d_mp = norm(mp - x_pos)
    h0 = torch.clamp(d_mp / attraction_distance, max=1.0).to(dtype)

    safe_h0 = torch.where(h0 != 0, h0, torch.ones_like(h0))
    g = (x_pos - mp).to(dtype) / safe_h0[..., None]
    J = torch.cat([g, torch.zeros_like(g)], dim=-1)

    lam_m = 1.0 / (sigma * sigma)
    jx0 = (J * v2f_mu.to(dtype)).sum(dim=-1)
    eta_f = J * (lam_m * (jx0 - h0))[..., None]
    lam_f = lam_m * J[..., :, None] * J[..., None, :]

    timed_out = timeout > 0
    minus_one = torch.full_like(timeout, -1)
    new_timeout = torch.where(
        timed_out, timeout - 1, torch.where(timeout == 0, minus_one, timeout)
    )
    path_done = (plen < 2) | (rec >= plen - 1)
    skipped = timed_out | path_done | (h0 == 0)

    keep = ~skipped
    eta_f = torch.where(keep[..., None], eta_f, torch.zeros_like(eta_f))
    lam_f = torch.where(keep[..., None, None], lam_f, torch.zeros_like(lam_f))
    new_record = torch.where(keep, new_record, record)
    return eta_f, lam_f, new_record, new_timeout, mp.to(dtype), h0, skipped
