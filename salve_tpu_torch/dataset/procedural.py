"""Procedural ZInD-format buildings: unlimited training geometry.

Generates `zind_data.json`-compatible dicts (the exact schema
common/pano_data.py parses — merger nesting, left-handed ego layouts,
floor_plan_transformation, flat W/D/O triplets) from a random grid floor
plan, so every pipeline stage and the verifier can train on as many
buildings as needed. The fixture set ships only two real buildings; the
reference's released models were trained on 587 tours — this closes the
data-scale gap for synthetic end-to-end runs.

World model (v7 — diversified toward the real-ZInD geometry distribution,
measured on fixture building 1210: per-pano ceiling ratios 1.58-2.53,
rectilinear non-rectangular rooms, varied W/D/O widths):
an R x C grid of rooms with some cells removed, L-shaped notches cut from
exterior corners (rooms become 6-vertex rectilinear polygons), doors /
openings of randomized width on shared interior walls (present in BOTH
adjacent rooms' W/D/O lists at coincident world coordinates — exactly what
Stage A aligns on), 1-2 windows per exterior wall, randomized camera and
ceiling heights per building, and 1-3 panos per room at clearance-checked
positions/headings.

v8 additions (closing the residual held-out-recall gap the v7 run measured
on real-geometry building 1210 — recall 0.64 at precision 0.73; the
remaining failures concentrate in geometry patterns v7 never generates):
  - corridor bands: one grid row/column squeezed to hallway width
    (1.4-2.0 m) in ~1/3 of buildings — feature-sparse elongated rooms with
    many doors, the hardest rooms in real tours;
  - exterior doors (~30%/room): closet/entry doors on exterior walls that
    lead nowhere — singleton W/D/Os that multiply Stage-A negative
    door-to-door pairings exactly like real closets do;
  - double L-notches: both eligible corners notched (8-vertex rectilinear
    polygons) when a room is large enough;
  - second door/opening on long (>=4.5 m) shared walls — multiple W/D/Os
    between ONE room pair, the classic Stage-A disambiguation challenge.

v9 additions (targeting the v8 error analysis on held-out 1210 — recall
0.71 at precision 0.72; the surviving false negatives cluster in exactly
two modes, see ACCURACY_r02.json error_analysis):
  - opening share 0.25 -> 0.40 and widths to 3.0 m, plus door+opening
    combinations on one long wall: 5 of 6 lost floor_01 edges were
    opening-connected pairs (p=0.12-0.31), and the worst false positives
    were rotated openings — v8 simply under-generated openings;
  - hub room: the largest room (>=13 m^2) gets 3-4 panos in 60% of
    buildings (1210 floor_02's room 02 holds 7 of 19 panos) — same-room
    pano pairs via a shared W/D/O were v8's lowest-scoring GT positives
    (p=0.11-0.21, 13 of 21 lost floor_02 edges touch one such pano);
  - spread placement: panos after the first maximize distance from the
    already-placed ones (0.35 m wall clearance), producing far/oblique
    views of the connecting W/D/O instead of always room-centered ones.

v10 additions (targeting the v9 error analysis on held-out 1210 — recall
0.78 at precision 0.83; the surviving false negatives are door/rotated
pairs seen from FAR positions, concentrated around multi-pano hub rooms,
ACCURACY_r03.json error_analysis):
  - far-from-door placement: panos repel the room's door/opening midpoints
    (half the time for later panos, 35% for first panos) instead of only
    repelling each other — the lost edges are views where the connecting
    door sits at maximum distance/obliquity, which v9 only produced
    incidentally;
  - hub rooms more often (0.6 -> 0.85 at a lower 11 m^2 area gate) with the
    4th pano more likely — more same-room and cross-room far pairs per
    building.

v11 additions (targeting the floor_01 forensics, ACCURACY_r03.json
floor_01_forensics — the residual 0.828 mode is two conf-0.99
wall-parallel opening-SLIDE false positives that no graph filter can
reject; the verifier must learn the mode, so the corpus must contain it):
  - same-width opening clusters: when the first W/D/O on a long shared
    wall is an opening, the second (when drawn) is an opening with the
    SAME width (+-4%) 60% of the time at the minimum legal gap — the
    wrong opening-to-opening pairing then passes Stage A's 0.8 GT width
    ratio gate and lands in incorrect_alignment training pools as a pure
    along-wall slide with portal-shared visible content (the exact family
    of 1210's poison edges 0->5 / 1->5).

A copy of salve_tpu/dataset/procedural.py (no JAX).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


def _ego_from_world(p_world_m, cam_xy, theta_deg, cam_h):
    """World-metric -> ego-normalized (camera at origin, height 1 unit).

    Inverse of generate_Sim2_from_floorplan_transform composed with the
    metric scale: p_wn = s (R p_ego + t) with R = rotmat2d(-rotation),
    S*s = cam_h; so p_ego = R^T (p_world_m - cam_world_m) / cam_h.
    """
    th = np.deg2rad(-theta_deg)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (np.asarray(p_world_m) - np.asarray(cam_xy)) @ R / cam_h


def _flip_x(points: np.ndarray) -> np.ndarray:
    """Right-handed ego -> ZInD's stored left-handed frame."""
    out = np.asarray(points, dtype=float).copy()
    out[..., 0] *= -1
    return out


def _wall_segment(center_xy, along, half_width):
    a = np.asarray(center_xy) - np.asarray(along) * half_width
    b = np.asarray(center_xy) + np.asarray(along) * half_width
    return a, b


def _point_in_poly(pt, poly) -> bool:
    """Even-odd ray cast; poly is (V,2), pt is (2,)."""
    x, y = float(pt[0]), float(pt[1])
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
            if x < xin:
                inside = not inside
    return inside


def _min_edge_dist(pt, poly) -> float:
    """Min distance from pt to the polygon's boundary segments."""
    p = np.asarray(pt, dtype=float)
    a = np.asarray(poly, dtype=float)
    b = np.roll(a, -1, axis=0)
    ab = b - a
    denom = np.maximum((ab * ab).sum(axis=1), 1e-12)
    t = np.clip(((p - a) * ab).sum(axis=1) / denom, 0.0, 1.0)
    proj = a + t[:, None] * ab
    return float(np.sqrt(((p - proj) ** 2).sum(axis=1)).min())


def _sample_camera_xy(rng, poly, spread_from=None) -> Tuple[float, float]:
    """A camera position inside the (possibly notched) room polygon.

    Rejection-sample with generous wall clearance, relax if the room is
    tight, and fall back to the in-polygon candidate with the largest
    clearance (small fixture rooms always admit one).

    v9: when `spread_from` (already-placed cameras in this room) is given,
    maximize the minimum distance to them subject to a relaxed 0.35 m wall
    clearance. Real multi-pano rooms shoot from opposite ends, so later
    panos see the connecting W/D/O far away and oblique — exactly the
    same-room pairs the v8 verifier scored lowest on held-out 1210
    (floor_02 rooms 02-02 pairs at p=0.11-0.21).
    """
    poly = np.asarray(poly, dtype=float)
    lo = poly.min(axis=0)
    hi = poly.max(axis=0)
    if spread_from:
        others = np.asarray(spread_from, dtype=float)
        best, best_d = None, -1.0
        for _ in range(300):
            pt = rng.uniform(lo, hi)
            if not _point_in_poly(pt, poly):
                continue
            if _min_edge_dist(pt, poly) < 0.35:
                continue
            d = float(np.min(np.linalg.norm(others - pt, axis=1)))
            if d > best_d:
                best, best_d = pt, d
        if best is not None:
            return float(best[0]), float(best[1])
        # No clearance-respecting candidate (degenerate sliver): fall through.
    best, best_d = None, -1.0
    for clearance in (0.7, 0.45):
        for _ in range(200):
            pt = rng.uniform(lo, hi)
            if not _point_in_poly(pt, poly):
                continue
            d = _min_edge_dist(pt, poly)
            if d > best_d:
                best, best_d = pt, d
            if d >= clearance:
                return float(pt[0]), float(pt[1])
    assert best is not None, "no interior camera position found"
    return float(best[0]), float(best[1])


def _notch_corner(named_poly, corner: str, dx: float, dy: float):
    """Cut an axis-aligned L-notch at a named corner of a CCW rectilinear
    polygon given as [(name, (x, y)), ...]; the corner vertex is replaced by
    three vertices tracing the notch (new vertices are unnamed)."""
    repl = {
        "BL": lambda x, y: [(x, y + dy), (x + dx, y + dy), (x + dx, y)],
        "BR": lambda x, y: [(x - dx, y), (x - dx, y + dy), (x, y + dy)],
        "TR": lambda x, y: [(x, y - dy), (x - dx, y - dy), (x - dx, y)],
        "TL": lambda x, y: [(x + dx, y), (x + dx, y - dy), (x, y - dy)],
    }[corner]
    out = []
    for name, (x, y) in named_poly:
        if name == corner:
            out.extend(("", pt) for pt in repl(x, y))
        else:
            out.append((name, (x, y)))
    return out


def _poly_area(poly) -> float:
    p = np.asarray(poly, dtype=float)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def generate_building_json(
    seed: int,
    n_rows: Optional[int] = None,
    n_cols: Optional[int] = None,
    scale_meters_per_coordinate: float = 3.5,
    version: int = 11,
    style: str = "default",
) -> Dict:
    """One procedural building as a zind_data.json-compatible dict.

    Args:
        version: generator vintage. 11 reproduces the round-4 corpus
            BYTE-EXACTLY for a given seed (held-out eval geometry is frozen
            at v11 for cross-round comparability; asserted in
            tests/dataset/test_procedural.py). 12 adds the round-5 levers
            (same-width DOOR twins, a per-building standard door width so
            most door pairs pass Stage A's 0.8 width-ratio gate — the
            exactly-90-deg rotation-FP family building 0038 exposed).
        style: "default", or "pathological" — two room wings joined by a
            single corridor cell whose only connections are one door per
            side (every wing-to-wing edge rides ONE hypothesis), plus
            forced far-from-door pano placement. Purpose-built VAL
            geometry: verifier misses on the bridge doors split the floor
            into components, so conditional Stage-D mechanisms (connectivity
            rescue, GLC) actually fire on val and the val method freeze can
            discriminate them (round-4 val was too clean: all configs tied).
            "rotation_trap" extends pathological with EXACTLY-equal door
            widths everywhere (no per-door jitter) and forced same-width
            door twins: every cross-wall door pairing passes Stage A's 0.8
            width-ratio gate, seeding the exactly-90-deg rotation-FP family
            (building 0038's failure mode) ON VAL — so the method freeze
            can elect the rotation-conflict resolver (rotfix) when it
            deserves it, instead of tying on geometry that never fires it
            (ACCURACY_r05 findings.val_discrimination_limit).
    """
    patho = style in ("pathological", "rotation_trap")
    rot_trap = style == "rotation_trap"
    if patho:
        version = max(version, 12)
    v12 = version >= 12
    rng = np.random.default_rng(seed)
    if patho:
        # Two wings of full columns around a single bridge column.
        R = n_rows or int(rng.integers(2, 4))
        C = n_cols or 3
    else:
        R = n_rows or int(rng.integers(2, 5))
        C = n_cols or int(rng.integers(2, 5))
    while R * C > 10:  # cap the floor size (real tours average ~8 rooms/floor)
        if R >= C:
            R -= 1
        else:
            C -= 1

    # Per-building height draws. Real ZInD: camera ~1.3-1.7 m, ego ceiling
    # ratio 1.58-2.53 on fixture 1210 (median 1.92).
    cam_base_m = float(rng.uniform(1.30, 1.70))
    ceil_m = float(np.clip(cam_base_m * rng.uniform(1.65, 2.25), 2.15, 3.4))
    # v12: per-building standard door width. Real homes hang same-size doors
    # everywhere; v11's independent 0.75-1.15 m draws often FAILED the 0.8
    # width-ratio gate, under-generating the wrong-door rotation negatives
    # (0038's residual FP family pairs equal-width doors at exactly 90 deg).
    door_w_base = float(rng.uniform(0.80, 1.05)) if v12 else None

    # Cell extents (shared walls): cumulative random sizes.
    widths = rng.uniform(2.4, 6.8, C)
    heights = rng.uniform(2.4, 6.2, R)
    bridge_col: Optional[int] = None
    if patho:
        # The bridge column is a corridor: elongated, feature-sparse, and
        # viewed obliquely — the bridge doors become genuinely hard edges.
        bridge_col = C // 2
        widths[bridge_col] = rng.uniform(1.4, 2.0)
    # v8: corridor band — squeeze one row (or column) to hallway width.
    # Real tours route most doors through feature-sparse elongated halls;
    # v7 never generated a room under 2.4 m across.
    elif rng.uniform() < 0.35:
        if rng.uniform() < 0.5 and R >= 2:
            heights[int(rng.integers(R))] = rng.uniform(1.4, 2.0)
        elif C >= 2:
            widths[int(rng.integers(C))] = rng.uniform(1.4, 2.0)
    xs = np.concatenate([[0.0], np.cumsum(widths)])
    ys = np.concatenate([[0.0], np.cumsum(heights)])

    # Drop some cells (keep the grid 4-connected by construction below).
    present = np.ones((R, C), dtype=bool)
    if patho:
        # Carve the bridge: keep ONE cell of the bridge column, drop the
        # rest. Each wing (full column block) reaches the other only through
        # that corridor cell's two doors.
        keep_row = int(rng.integers(R))
        for r in range(R):
            if r != keep_row:
                present[r, bridge_col] = False
    else:
        for _ in range(int(rng.integers(0, R * C // 3 + 1))):
            r, c = int(rng.integers(R)), int(rng.integers(C))
            trial = present.copy()
            trial[r, c] = False
            if trial.sum() >= 2 and _is_connected(trial):
                present = trial

    # Interior wall lines (axis, coord, lo, hi): notches never touch these,
    # and window placement must avoid them.
    interior_walls = []
    for r in range(R):
        for c in range(C):
            if not present[r, c]:
                continue
            if c + 1 < C and present[r, c + 1]:
                interior_walls.append(("v", xs[c + 1], ys[r], ys[r + 1]))
            if r + 1 < R and present[r + 1, c]:
                interior_walls.append(("h", ys[r + 1], xs[c], xs[c + 1]))

    def _edge_is_interior(p0, p1) -> bool:
        (x0, y0), (x1, y1) = p0, p1
        for axis, coord, lo, hi in interior_walls:
            if axis == "v" and abs(x0 - coord) < 1e-9 and abs(x1 - coord) < 1e-9:
                if min(y0, y1) >= lo - 1e-9 and max(y0, y1) <= hi + 1e-9:
                    return True
            if axis == "h" and abs(y0 - coord) < 1e-9 and abs(y1 - coord) < 1e-9:
                if min(x0, x1) >= lo - 1e-9 and max(x0, x1) <= hi + 1e-9:
                    return True
        return False

    # Room polygons, CCW world-metric. Rooms with an exterior corner get an
    # L-notch with probability 0.45 (rectilinear 6-gons, like real homes);
    # a second eligible corner of a large room is notched with probability
    # 0.4 (v8: 8-vertex rectilinear polygons). Interior (shared) walls are
    # never modified, so door coincidence and the grid contracts are
    # preserved; per-notch cuts are capped at 0.38 x the room extent so two
    # notches can never meet along a shared side.
    rooms: Dict[Tuple[int, int], np.ndarray] = {}
    for r in range(R):
        for c in range(C):
            if not present[r, c]:
                continue
            x0, x1, y0, y1 = xs[c], xs[c + 1], ys[r], ys[r + 1]
            w, h = x1 - x0, y1 - y0
            poly = [
                ("BL", (x0, y0)), ("BR", (x1, y0)),
                ("TR", (x1, y1)), ("TL", (x0, y1)),
            ]
            left_ext = c == 0 or not present[r, c - 1]
            right_ext = c + 1 == C or not present[r, c + 1]
            bot_ext = r == 0 or not present[r - 1, c]
            top_ext = r + 1 == R or not present[r + 1, c]
            corners = []
            if left_ext and bot_ext:
                corners.append("BL")
            if right_ext and bot_ext:
                corners.append("BR")
            if right_ext and top_ext:
                corners.append("TR")
            if left_ext and top_ext:
                corners.append("TL")
            n_notch = 0
            if corners and w >= 2.9 and h >= 2.9 and rng.uniform() < 0.45:
                n_notch = 1
                if len(corners) >= 2 and w >= 4.0 and h >= 4.0 and rng.uniform() < 0.4:
                    n_notch = 2
            for corner in list(rng.permutation(corners))[:n_notch]:
                dx = float(rng.uniform(0.7, 0.38 * w))
                dy = float(rng.uniform(0.7, 0.38 * h))
                poly = _notch_corner(poly, corner, dx, dy)
            rooms[(r, c)] = np.array([pt for _, pt in poly])

    # W/D/Os per room, as (type, world endpoint a, world endpoint b, bz, tz)
    # in meters. Doors/openings live on shared interior walls and are
    # duplicated into both rooms at coincident world coordinates.
    wdos: Dict[Tuple[int, int], List] = {rc: [] for rc in rooms}
    for (r, c) in rooms:
        for nbr, line in (
            ((r, c + 1), ("v", xs[c + 1], ys[r], ys[r + 1])),
            ((r + 1, c), ("h", ys[r + 1], xs[c], xs[c + 1])),
        ):
            if nbr not in rooms:
                continue
            # v9: 0.25 -> 0.40 opening share, widths up to 3.0 m. Held-out
            # 1210 floor_01 is opening-connected (rooms 02/05/06), and the
            # v8 verifier both under-recalled GT opening pairs (p=0.12-0.31)
            # and produced its worst false positives on rotated openings —
            # openings were simply rare in the v8 corpus.
            axis0 = line[0]
            bridge_wall = (
                patho
                and axis0 == "v"
                and (c == bridge_col or c + 1 == bridge_col)
            )
            # rotation_trap: doors dominate (openings rarely pair at 90 deg).
            is_opening = rng.uniform() < (0.15 if rot_trap else 0.40)
            if bridge_wall:
                # The wing-to-corridor connection is always a standard DOOR
                # (the symmetric, hard-to-verify case) — and exactly one.
                is_opening = False
            if v12 and not is_opening:
                # rotation_trap: the building's standard width EXACTLY — any
                # door pairs with any rotated door through the width gate.
                jitter = 1.0 if rot_trap else float(rng.uniform(0.93, 1.07))
                width = float(door_w_base * jitter)
            else:
                width = float(
                    rng.uniform(1.3, 3.0) if is_opening else rng.uniform(0.75, 1.15)
                )
            axis, coord, lo_w, hi_w = line
            lo, hi = lo_w + 0.5 + width / 2, hi_w - 0.5 - width / 2
            if hi <= lo:
                # Narrow shared wall: shrink toward a standard door
                # (rotation_trap keeps the exact building-standard width).
                width = min(door_w_base, 0.8) if rot_trap else 0.8
                lo, hi = lo_w + 0.4 + width / 2, hi_w - 0.4 - width / 2
                is_opening = False
                if hi <= lo:
                    continue
            cu = rng.uniform(lo, hi)
            placed = [(cu, width)]
            # v8: a second door/opening on long shared walls — multiple
            # W/D/Os between ONE room pair is the classic Stage-A
            # disambiguation case (which of the two doors matches?).
            second_is_opening = False
            twin_len = 3.6 if rot_trap else 4.5
            twin_p = 0.9 if rot_trap else 0.4
            if hi_w - lo_w >= twin_len and not bridge_wall and rng.uniform() < twin_p:
                # v9: the second W/D/O is an opening 30% of the time
                # (door+opening on one wall — e.g. a kitchen pass-through
                # beside its door — appears in real tours and forces the
                # verifier to rank door-vs-opening evidence).
                # v11: after an opening, the second is a SAME-width opening
                # 60% of the time at the minimum legal gap — Stage A's
                # wrong pairing of the twins is a pure along-wall slide
                # that passes the 0.8 width-ratio gate, seeding the
                # opening-slide hard negatives floor_01's poison edges
                # showed the verifier never trained on.
                if v12:
                    # v12: same-width twins for DOORS too (0.55) — the
                    # wrong-door pairing of equal-width doors is the exact
                    # negative family 0038's rotation FPs live in; v11 only
                    # seeded opening twins. rotation_trap: always.
                    same_width_twin = rng.uniform() < (
                        1.0 if rot_trap else (0.6 if is_opening else 0.55)
                    )
                    second_is_opening = (
                        is_opening if same_width_twin else rng.uniform() < 0.3
                    )
                else:
                    same_width_twin = is_opening and rng.uniform() < 0.6
                    second_is_opening = same_width_twin or rng.uniform() < 0.3
                if same_width_twin:
                    w2 = float(width if rot_trap else width * rng.uniform(0.96, 1.04))
                elif v12 and not second_is_opening:
                    w2 = float(door_w_base * rng.uniform(0.93, 1.07))
                else:
                    w2 = float(
                        rng.uniform(1.3, 2.2)
                        if second_is_opening
                        else rng.uniform(0.75, 1.15)
                    )
                lo2, hi2 = lo_w + 0.5 + w2 / 2, hi_w - 0.5 - w2 / 2
                min_gap = (width + w2) / 2 + (
                    rng.uniform(0.3, 0.7) if same_width_twin else 0.3
                )
                if same_width_twin and lo2 < hi2:
                    # Place the twin adjacent to the first opening (at the
                    # minimal gap) rather than uniformly: small slides are
                    # the hard ones.
                    side = 1.0 if rng.uniform() < 0.5 else -1.0
                    cu2 = cu + side * min_gap
                    if not (lo2 <= cu2 <= hi2):
                        cu2 = cu - side * min_gap
                    if lo2 <= cu2 <= hi2:
                        placed.append((float(cu2), w2))
                if len(placed) == 1:
                    for _ in range(12):
                        cu2 = rng.uniform(lo2, hi2) if lo2 < hi2 else lo2
                        if lo2 < hi2 and abs(cu2 - cu) >= min_gap:
                            placed.append((float(cu2), w2))
                            break
            along = (0.0, 1.0) if axis == "v" else (1.0, 0.0)
            for k_wdo, (cu_k, w_k) in enumerate(placed):
                center = (coord, cu_k) if axis == "v" else (cu_k, coord)
                a, b = _wall_segment(center, along, w_k / 2)
                opening_k = (is_opening and k_wdo == 0) or (
                    second_is_opening and k_wdo == 1
                )
                kind = "openings" if opening_k else "doors"
                top = (
                    min(2.4, ceil_m - 0.15)
                    if opening_k
                    else min(float(rng.uniform(1.95, 2.2)), ceil_m - 0.25)
                )
                wdos[(r, c)].append((kind, a, b, 0.0, top))
                wdos[nbr].append((kind, a, b, 0.0, top))

        # Windows on exterior polygon edges (1-2 per long edge).
        poly = rooms[(r, c)]
        free_exterior_edges = []
        for i in range(len(poly)):
            p0, p1 = poly[i], poly[(i + 1) % len(poly)]
            if _edge_is_interior(p0, p1):
                continue
            span = float(np.linalg.norm(p1 - p0))
            win_w = float(rng.uniform(0.9, 1.8))
            # One window per exterior edge at most: Stage-A hypothesis count
            # scales ~ pairs x wdo x wdo, and training cost scales with it.
            if span < win_w + 1.2 or rng.uniform() < 0.5:
                if span >= 2.2:
                    free_exterior_edges.append((p0, p1, span))
                continue
            along = (p1 - p0) / span
            u = rng.uniform(0.5 + win_w / 2, span - 0.5 - win_w / 2)
            center = p0 + along * u
            a, b = _wall_segment(center, along, win_w / 2)
            w_bot = float(rng.uniform(0.7, 1.0))
            w_top = min(float(rng.uniform(1.75, 2.25)), ceil_m - 0.25)
            wdos[(r, c)].append(("windows", a, b, w_bot, w_top))

        # v8: exterior door (closet / entry door that leads nowhere) on a
        # window-free exterior edge. Singleton doors multiply the Stage-A
        # negative door-to-door pairings exactly like real closets do.
        if free_exterior_edges and rng.uniform() < 0.3:
            p0, p1, span = free_exterior_edges[
                int(rng.integers(len(free_exterior_edges)))
            ]
            if rot_trap:
                d_w = float(door_w_base)  # exact: every door pairs at 90 deg
            elif v12:
                d_w = float(door_w_base * rng.uniform(0.93, 1.07))
            else:
                d_w = float(rng.uniform(0.75, 1.1))
            along = (p1 - p0) / span
            u = rng.uniform(0.5 + d_w / 2, span - 0.5 - d_w / 2)
            a, b = _wall_segment(p0 + along * u, along, d_w / 2)
            top = min(float(rng.uniform(1.95, 2.2)), ceil_m - 0.25)
            wdos[(r, c)].append(("doors", a, b, 0.0, top))

    # Panos: 1-2 per room plus one multi-pano hub room per building.
    merger_floor: Dict[str, Dict] = {}
    pano_id = 0
    S = float(scale_meters_per_coordinate)
    # v9: hub room — real tours shoot the main living space 4-8 times
    # (1210 floor_02's room 02 holds 7 of 19 panos), and the v8 verifier's
    # weakest held-out edges were exactly those same-room pairs. Pick the
    # largest room (if big enough) and give it 3-4 spread-out panos.
    areas = {rc: _poly_area(p) for rc, p in rooms.items()}
    hub_rc = max(areas, key=areas.get)
    hub_panos = 0
    # v10: more hub rooms (0.6 -> 0.85, area gate 13 -> 11 m^2), 4th pano
    # more likely — the v9 residual FNs all touch multi-pano rooms.
    if areas[hub_rc] >= 11.0 and rng.uniform() < 0.85:
        hub_panos = 3 + int(areas[hub_rc] >= 18.0 and rng.uniform() < 0.6)
    for k, ((r, c), poly) in enumerate(sorted(rooms.items())):
        complete = f"complete_room_{k:02d}"
        merger_floor[complete] = {}
        area = areas[(r, c)]
        # 1-2 panos per room (second more likely in big rooms): pano pairs
        # grow quadratically in pano count, and with them rendering +
        # training cost per building.
        if (r, c) == hub_rc and hub_panos:
            n_panos = hub_panos
        else:
            n_panos = 1
            if rng.uniform() < min(0.55, area / 28.0):
                n_panos += 1
        # v10: door/opening midpoints as repulsors — the v9 residual FNs are
        # door pairs seen from maximum distance/obliquity, which pure
        # pano-pano spreading only produces incidentally.
        wdo_mids = [
            tuple((np.asarray(a) + np.asarray(b)) / 2.0)
            for kind, a, b, _, _ in wdos[(r, c)]
            if kind in ("doors", "openings")
        ]
        placed_xy: List[Tuple[float, float]] = []
        for j in range(n_panos):
            partial = f"partial_room_{k:02d}"
            pano_key = f"pano_{pano_id}"
            repel: List[Tuple[float, float]] = list(placed_xy) if j > 0 else []
            # Pathological val: ALWAYS repel the connecting doors — bridge
            # edges are then seen far and oblique, maximizing the chance the
            # verifier actually misses one on val (which is the point).
            p_repel = 1.1 if patho else (0.5 if j > 0 else 0.35)
            if wdo_mids and rng.uniform() < p_repel:
                repel = repel + wdo_mids
            cx, cy = _sample_camera_xy(
                rng, poly, spread_from=repel if repel else None
            )
            placed_xy.append((cx, cy))
            theta = float(rng.uniform(0.0, 360.0))
            cam_h = float(np.clip(cam_base_m + rng.uniform(-0.06, 0.06), 1.2, 1.8))

            verts_ego = _ego_from_world(poly, (cx, cy), theta, cam_h)
            layout = {
                "vertices": _flip_x(verts_ego).tolist(),
                "doors": [],
                "windows": [],
                "openings": [],
            }
            for kind, a, b, bz_m, tz_m in wdos[(r, c)]:
                a_e = _flip_x(_ego_from_world(a, (cx, cy), theta, cam_h))
                b_e = _flip_x(_ego_from_world(b, (cx, cy), theta, cam_h))
                # z stored ego-normalized: floor plane sits at -1.
                bz = (bz_m - cam_h) / cam_h
                tz = (tz_m - cam_h) / cam_h
                layout[kind].extend(
                    [list(map(float, a_e)), list(map(float, b_e)), [bz, tz]]
                )

            s_pano = cam_h / S
            image_path = (
                f"panos/floor_01_partial_room_{k:02d}_pano_{pano_id}.jpg"
            )
            merger_floor[complete].setdefault(partial, {})[pano_key] = {
                "camera_height": 1.0,
                # Ego-normalized, like real ZInD (floor at -1, ceiling at
                # ceiling_height - 1); consumed by synthetic_zind.py to set
                # the rendered world's ceiling plane.
                "ceiling_height": ceil_m / cam_h,
                "checksum": "",
                "floor_number": 1,
                "is_ceiling_flat": True,
                "is_inside": True,
                "is_primary": j == 0,
                "label": rng.choice(
                    ["bedroom", "living room", "kitchen", "bathroom", "office"]
                ),
                "image_path": image_path,
                "floor_plan_transformation": {
                    "rotation": theta,
                    # ZInD stores the transform in the LEFT-handed frame: the
                    # parser (common/pano_data.py:
                    # generate_Sim2_from_floorplan_transform) negates the
                    # stored translation's x, so the camera's world position
                    # (cx, cy) must be stored as (-cx, cy) in world-normalized
                    # units. (A +cx here shifts every pano's parsed world by
                    # -2cx: each room stays self-consistent — axis-aligned,
                    # camera inside — but shared doors stop coinciding across
                    # panos, which silently destroys all cross-pano GT labels;
                    # see tests/dataset/test_procedural.py's shared-door
                    # world-coincidence test.)
                    "translation": [-cx / S, cy / S],
                    "scale": s_pano,
                },
                "layout_raw": dict(layout),
                "layout_complete": dict(layout),
            }
            pano_id += 1

    return {
        "redraw": {},
        "floorplan_to_redraw_transformation": {},
        "scale_meters_per_coordinate": {"floor_01": S},
        "merger": {"floor_01": merger_floor},
    }


def _is_connected(present: np.ndarray) -> bool:
    """4-connectivity check of the room grid."""
    R, C = present.shape
    cells = list(zip(*np.nonzero(present)))
    if not cells:
        return False
    seen = {cells[0]}
    stack = [cells[0]]
    while stack:
        r, c = stack.pop()
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            n = (r + dr, c + dc)
            if 0 <= n[0] < R and 0 <= n[1] < C and present[n] and n not in seen:
                seen.add(n)
                stack.append(n)
    return len(seen) == int(present.sum())


def write_procedural_buildings(
    out_zind_dir: str,
    building_ids: List[str],
    base_seed: int = 0,
    version: int = 11,
    styles: Optional[Dict[str, str]] = None,
) -> None:
    """Write zind_data.json for each building id (geometry only; pair with
    dataset/synthetic_zind.py to materialize imagery + depth).

    Resume contract (same as every other producer in the pipeline): an id
    whose zind_data.json already exists is NEVER rewritten. The generator
    evolves between corpus versions (v7 -> v8 -> v9 change the rng
    consumption for a given seed), while materialized panos/depth/BEVs on
    disk were rendered from the geometry as it existed at write time —
    regenerating the JSON under newer code would silently mismatch every
    downstream artifact and corrupt the GT labels. Skipping also lets one
    output dir accumulate a mixed-version corpus incrementally (e.g. add
    v9 buildings under fresh ids beside an existing v8 set).
    """
    for bid in building_ids:
        bdir = Path(out_zind_dir) / bid
        out_fpath = bdir / "zind_data.json"
        if out_fpath.exists():
            continue
        bdir.mkdir(parents=True, exist_ok=True)
        data = generate_building_json(
            seed=base_seed * 99991 + int(bid),
            version=version,
            style=(styles or {}).get(bid, "default"),
        )
        with open(out_fpath, "w") as f:
            json.dump(data, f)
