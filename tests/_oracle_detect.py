"""Literal NumPy/SciPy oracle for the DETECTION BOOKKEEPING chain.

Every numeric detection stage is oracle-pinned, but
the label bookkeeping -- component grouping -> min-y sorting -> polynomial
fitting -> first-row/last-col pruning -> scipy-root intersections ->
positional relabeling -> brightness-centered id assignment -> JSON assembly
-- was pinned only against the repo's own golden fixtures.  This module is a
function-for-function transliteration of that chain from the reference
(/root/reference/utils/util_cylinder.py), so the repo detector's stages
6b-6g can be replayed independently from the detector's own post-bridge
state (masks + centroids + bbox, via the ``bridge_state`` probe).

Like tests/_oracle.py it is intentionally a near-copy of reference logic:
it lives only under tests/, is imported by nothing in the package, and each
function declares its provenance.  Substitutions forced by the environment
(cv2/skimage are not installed):

- cv2.connectedComponents       -> scipy.ndimage.label (8-connectivity;
  both assign labels in raster order of first encounter)
- cv2.GaussianBlur(ksize, 0)    -> separable NumPy convolution with the
  OpenCV kernel (sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8, REFLECT_101 border)
- centroids arrive as floats (the repo keeps subpixel moments; the
  reference casts to int at extract_joints).  Label lookups use int()
  truncation exactly like the reference's integer indexing; all later
  arithmetic is float-transparent.
"""

from __future__ import annotations

import json
import math
import re

import numpy as np
from scipy import ndimage
from scipy.optimize import root

_EIGHT = np.ones((3, 3), dtype=bool)


# ---------------------------------------------------------------------------
# labeling + grouping (ref utils/util_cylinder.py:24-33, 376-430)


def label_masks(mask: np.ndarray) -> np.ndarray:
    """ref label_and_color_masks utils/util_cylinder.py:24-33 (coloring
    dropped): 8-connected components, labels in raster order, 0=background."""
    labels, _ = ndimage.label(np.asarray(mask, bool), structure=_EIGHT)
    return labels


def group_points_by_label(points, labels, x_offset, y_offset):
    """ref utils/util_cylinder.py:376-389.  NOTE the reference sorts BOTH
    rows and cols with sort_rows (min member y) -- sort_cols (:397-399)
    exists but is never called on the main path."""
    points_grouped = {}
    for point in points:
        cX, cY = point
        rx = int(cX - x_offset)
        ry = int(cY - y_offset)
        if 0 <= ry < labels.shape[0] and 0 <= rx < labels.shape[1]:
            label = labels[ry, rx]
            if label > 0:
                if label not in points_grouped:
                    points_grouped[label] = []
                points_grouped[label].append((cX, cY))
    return sort_rows(points_grouped)


def sort_rows(points_grouped):
    """ref utils/util_cylinder.py:392-394: sort groups by min member y."""
    return sorted(
        points_grouped.items(),
        key=lambda item: min(point[1] for point in item[1]),
    )


def create_dummy_rows_cols(sorted_rows, sorted_cols, degree=2):
    """ref utils/util_cylinder.py:401-430: name groups row1../col1.. in the
    sorted order and give every one a dummy [0]*(degree+4) equation."""
    rows = {"points": {}, "equations": {}}
    for i, (_, points) in enumerate(sorted_rows, start=1):
        rows["points"][f"row{i}"] = points
        rows["equations"][f"row{i}"] = [0] * (degree + 4)
    cols = {"points": {}, "equations": {}}
    for i, (_, points) in enumerate(sorted_cols, start=1):
        cols["points"][f"col{i}"] = points
        cols["equations"][f"col{i}"] = [0] * (degree + 4)
    return rows, cols


# ---------------------------------------------------------------------------
# polynomial fitting (ref utils/util_cylinder.py:454-550)


def fit_polynomials(rows, cols, degree=2):
    """ref fit_and_draw_polynomial utils/util_cylinder.py:473-550 (drawing
    dropped).  Rows fit y=f(x) over x-sorted float32 points, cols x=f(y)
    over y-sorted points; domains extended by +-50; groups with < degree+1
    points keep their dummy equation (the reference `continue`s)."""
    for col_name, points in cols["points"].items():
        if len(points) < degree + 1:
            continue
        pts = np.array(points, dtype=np.float32)
        pts = pts[np.argsort(pts[:, 1], kind="stable")]
        y_vals, x_vals = pts[:, 1], pts[:, 0]
        poly_coeff = np.polyfit(y_vals, x_vals, degree)
        y_min, y_max = float(y_vals.min()) - 50, float(y_vals.max()) + 50
        cols["equations"][col_name] = list(poly_coeff) + [
            y_min, y_max, abs(y_max - y_min)
        ]
    for row_name, points in rows["points"].items():
        if len(points) < degree + 1:
            continue
        pts = np.array(points, dtype=np.float32)
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        x_vals, y_vals = pts[:, 0], pts[:, 1]
        poly_coeff = np.polyfit(x_vals, y_vals, degree)
        x_min, x_max = float(x_vals.min()) - 50, float(x_vals.max()) + 50
        rows["equations"][row_name] = list(poly_coeff) + [
            x_min, x_max, abs(x_max - x_min)
        ]
    return rows, cols


def fit_polynomials_plane(rows, cols, degree=1):
    """ref utils/util_plane.py:411-634 fit_and_draw_polynomial (drawing
    dropped): cols fitted with +-10 domains first, abnormal columns
    (span <= 0.9 * max span, spans INCLUDING the +-10 extension) merged
    greedily in numeric label order while the cumulative span stays within
    the max, merged groups refit and relabeled col1..N by first-member
    number, then a final pass restores +-50 domains for every col; rows
    fitted once with +-50 like the cylinder path."""
    for col_name, points in cols["points"].items():
        if len(points) < degree + 1:
            continue
        pts = np.array(points, dtype=np.float32)
        pts = pts[np.argsort(pts[:, 1], kind="stable")]
        y_vals, x_vals = pts[:, 1], pts[:, 0]
        poly_coeff = np.polyfit(y_vals, x_vals, degree)
        y_min, y_max = float(y_vals.min()) - 10, float(y_vals.max()) + 10
        cols["equations"][col_name] = list(poly_coeff) + [
            y_min, y_max, abs(y_min - y_max)
        ]
    threshold_value = max(
        (abs(eq[-1]) for eq in cols["equations"].values()), default=0
    )
    abnormal = [
        k for k, eq in cols["equations"].items()
        if abs(eq[-1]) <= 0.9 * threshold_value
    ]
    merge_groups, current, cumulative = [], [], 0
    ordered = sorted(
        cols["equations"].keys(),
        key=lambda x: int("".join(filter(str.isdigit, x)) or 0),
    )
    for name in ordered:
        if name in abnormal:
            d = abs(cols["equations"][name][-1])
            if cumulative + d <= threshold_value:
                current.append(name)
                cumulative += d
            else:
                if current:
                    merge_groups.append(current)
                current, cumulative = [name], d
        else:
            if current:
                merge_groups.append(current)
                current, cumulative = [], 0
    if current:
        merge_groups.append(current)
    for group in merge_groups:
        merged_points = []
        for name in group:
            merged_points.extend(cols["points"][name])
            del cols["points"][name]
            del cols["equations"][name]
        if len(merged_points) < degree + 1:
            continue
        pts = np.array(merged_points, dtype=np.float32)
        pts = pts[np.argsort(pts[:, 1], kind="stable")]
        y_vals, x_vals = pts[:, 1], pts[:, 0]
        poly_coeff = np.polyfit(y_vals, x_vals, degree)
        y_min, y_max = float(y_vals.min()), float(y_vals.max())
        name = "_".join(group)
        cols["equations"][name] = list(poly_coeff) + [
            y_min, y_max, abs(y_min - y_max)
        ]
        cols["points"][name] = merged_points
    relabeled = sorted(
        cols["equations"].keys(),
        key=lambda x: int(x.split("_")[0].replace("col", "")),
    )
    cols["equations"] = {
        f"col{i}": cols["equations"][k] for i, k in enumerate(relabeled, 1)
    }
    cols["points"] = {
        f"col{i}": cols["points"][k] for i, k in enumerate(relabeled, 1)
    }
    for col_name, equation in list(cols["equations"].items()):
        if len(cols["points"][col_name]) < degree + 1:
            continue
        pts = np.array(cols["points"][col_name], dtype=np.float32)
        y_vals = np.sort(pts[:, 1], kind="stable")
        poly_coeff = equation[: degree + 1]
        y_min, y_max = float(y_vals.min()) - 50, float(y_vals.max()) + 50
        cols["equations"][col_name] = list(poly_coeff) + [
            y_min, y_max, abs(y_min - y_max)
        ]
    for row_name, points in rows["points"].items():
        if len(points) < degree + 1:
            continue
        pts = np.array(points, dtype=np.float32)
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
        x_vals, y_vals = pts[:, 0], pts[:, 1]
        poly_coeff = np.polyfit(x_vals, y_vals, degree)
        x_min, x_max = float(x_vals.min()) - 50, float(x_vals.max()) + 50
        rows["equations"][row_name] = list(poly_coeff) + [
            x_min, x_max, abs(x_max - x_min)
        ]
    return rows, cols


# ---------------------------------------------------------------------------
# pruning (ref utils/util_cylinder.py:1211-1269)


def remove_label(rows, cols):
    """ref utils/util_cylinder.py:1211-1269: drop the FIRST row label and the
    LAST col label in the stored (min-y sorted) key order, then rename the
    remainder 1..N.  The reference renames BOTH sides with the default
    prefix 'col' (rows become col1.. until clean_and_relabel renames them
    back) -- downstream only iterates values, so the quirk is preserved but
    invisible; we keep per-side prefixes for readability."""

    def _remove(data, n_start, n_end, prefix):
        original_keys = list(data["equations"].keys())
        keys_to_remove = original_keys[:n_start] + (
            original_keys[-n_end:] if n_end > 0 else []
        )
        for key in keys_to_remove:
            data["equations"].pop(key, None)
            data["points"].pop(key, None)
        remaining = [k for k in original_keys if k not in keys_to_remove]
        data["equations"] = {
            f"{prefix}{i}": data["equations"][k]
            for i, k in enumerate(remaining, start=1)
        }
        data["points"] = {
            f"{prefix}{i}": data["points"][k]
            for i, k in enumerate(remaining, start=1)
        }
        return data

    rows = _remove(rows, 1, 0, "row")
    cols = _remove(cols, 0, 1, "col")
    return rows, cols


# ---------------------------------------------------------------------------
# intersections (ref utils/util_cylinder.py:1074-1151)


def poly_intersection_solver(row_eq, col_eq, degree):
    """ref utils/util_cylinder.py:1074-1104, literal (scipy hybr root)."""
    row_coeff = row_eq[: degree + 1]
    x_min, x_max = row_eq[degree + 1], row_eq[degree + 2]
    col_coeff = col_eq[: degree + 1]
    y_min, y_max = col_eq[degree + 1], col_eq[degree + 2]

    def func(v):
        x, y = v[0], v[1]
        return [y - np.polyval(row_coeff, x), x - np.polyval(col_coeff, y)]

    x0 = 0.5 * (x_min + x_max)
    y0 = np.polyval(row_coeff, x0)
    sol = root(func, [x0, y0], method="hybr")
    if sol.success:
        x_sol, y_sol = sol.x[0], sol.x[1]
        if (x_min - 1e-3 <= x_sol <= x_max + 1e-3) and (
            y_min - 1e-3 <= y_sol <= y_max + 1e-3
        ):
            return (x_sol, y_sol)
    return None


def find_and_assign_intersections(rows, cols, bbox, degree=2):
    """ref find_and_assign_intersections_P utils/util_cylinder.py:1106-1151
    (drawing dropped).  bbox = (x, y, w, h); the in-rect gate is inclusive
    on both ends, like the reference."""
    rect_x, rect_y, rect_w, rect_h = bbox
    rows_updated = {
        "points": {k: [] for k in rows["points"]},
        "equations": rows["equations"],
    }
    cols_updated = {
        "points": {k: [] for k in cols["points"]},
        "equations": cols["equations"],
    }
    for row_name, row_eq in rows["equations"].items():
        if len(row_eq) < degree + 3:
            continue
        for col_name, col_eq in cols["equations"].items():
            if len(col_eq) < degree + 3:
                continue
            pt = poly_intersection_solver(row_eq, col_eq, degree)
            if pt is None:
                continue
            x_sol, y_sol = pt
            if (rect_x <= x_sol <= rect_x + rect_w) and (
                rect_y <= y_sol <= rect_y + rect_h
            ):
                rows_updated["points"][row_name].append((float(x_sol), float(y_sol)))
                cols_updated["points"][col_name].append((float(x_sol), float(y_sol)))
    return rows_updated, cols_updated


# ---------------------------------------------------------------------------
# relabel (ref utils/util_cylinder.py:1154-1206)


def clean_and_relabel(rows, cols):
    """ref utils/util_cylinder.py:1154-1206: drop empty labels, re-sort rows
    by mean member y / cols by mean member x, rename 1..N.  Equations follow
    their label unless exactly [0, 0, 0, 0] (degree-2 dummies are [0]*6 and
    therefore survive, as in the reference)."""

    def _process(data, prefix, sort_axis):
        points = data.get("points", {})
        equations = data.get("equations", {})
        filtered = {k: p for k, p in points.items() if p}
        avg = {
            k: (np.mean([pt[sort_axis] for pt in p]) if p else float("inf"))
            for k, p in filtered.items()
        }
        ordered = sorted(filtered.keys(), key=lambda k: avg[k])
        new_points, new_equations = {}, {}
        for i, old in enumerate(ordered, start=1):
            new = f"{prefix}{i}"
            new_points[new] = filtered[old]
            if old in equations and equations[old] != [0, 0, 0, 0]:
                new_equations[new] = equations[old]
        return new_points, new_equations

    rows["points"], rows["equations"] = _process(rows, "row", 1)
    cols["points"], cols["equations"] = _process(cols, "col", 0)
    return rows, cols


# ---------------------------------------------------------------------------
# center indexing (ref utils/util_cylinder.py:1350-1571)


def _gaussian_blur_cv(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), 0) on float input: OpenCV's
    auto sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8, REFLECT_101 border
    (np.pad mode='reflect')."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) // 2
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(t**2) / (2 * sigma * sigma))
    k /= k.sum()
    p = np.pad(np.asarray(img, np.float64), r, mode="reflect")
    p = ndimage.convolve1d(p, k, axis=0, mode="constant")
    p = ndimage.convolve1d(p, k, axis=1, mode="constant")
    return p[r:-r, r:-r]


def indexing_data(rows, cols, gray, circle_radius0, id_row_major=False,
                  patch_rule="cylinder"):
    """ref indexing_data utils/util_cylinder.py:1350-1571 / the plane
    variant utils/util_plane.py:1255-1471 (ThreadPool fanout replaced by
    plain loops; identical reductions).  The two references differ in
    exactly two places, exposed as parameters: point ids are
    (col, row) on the cylinder path (:1497) but (row, col) on the plane
    path (util_plane :1398, 1420), and the brightness patch half-size is
    max(3, cr/5) (+5 above 10) vs the plane's bare int(cr/4.5)
    (util_plane :1280).  Returns (rows_dict, cols_dict, center_point) --
    the downstream consumer is make_json(center_point, cols_dict) after
    remove_minus_labels on the cylinder path only (ref :2052-2055,
    util_plane :2840)."""

    def validate_points(points):
        return [
            p
            for p in points
            if isinstance(p, (list, tuple))
            and len(p) == 2
            and all(
                isinstance(c, (int, float))
                and not math.isnan(c)
                and not math.isinf(c)
                for c in p
            )
        ]

    def calculate_average_brightness(image, point):
        # ref :1373-1384: patch spans [int(x-h), int(x+h)) -- 2h wide.
        x, y = point
        if patch_rule == "plane":
            half = int(circle_radius0 / 4.5)  # ref util_plane.py:1280
        else:
            half = max(int(circle_radius0 / 5), 3)
            if half > 10:
                half = half + 5
        x0, x1 = max(0, int(x - half)), min(image.shape[1], int(x + half))
        y0, y1 = max(0, int(y - half)), min(image.shape[0], int(y + half))
        return float(np.mean(image[y0:y1, x0:x1]))

    def closest_label(point, groups):
        best, best_d = None, float("inf")
        for label, pts in groups.items():
            for p in pts:
                d = math.hypot(point[0] - p[0], point[1] - p[1])
                if d < best_d:
                    best_d, best = d, label
        return best

    row_points_raw = rows.get("points", {})
    validated_row_points = {}
    for label, points in row_points_raw.items():
        vp = validate_points(points)
        if vp:
            validated_row_points[label] = vp
    if not validated_row_points:
        return None, None, None

    gaussian_image = _gaussian_blur_cv(gray, 7)

    brightness_results = []
    for label, points in validated_row_points.items():
        for point in points:
            brightness_results.append(
                (calculate_average_brightness(gaussian_image, point), point)
            )
    if not brightness_results:
        return None, None, None
    # literal max() like the reference (:1456): with all-NaN brightness
    # (possible on the plane path when int(circle_radius/4.5) == 0 makes
    # every patch empty) Python's max returns the FIRST item -- preserve
    # that quirk rather than "fixing" it
    center_point = max(brightness_results, key=lambda t: t[0])[1]

    center_row_label = closest_label(center_point, row_points_raw)
    center_col_label = closest_label(center_point, cols.get("points", {}))
    if center_col_label is None:
        return None, None, None
    center_row_num = int(center_row_label.replace("row", ""))
    center_col_num = int(center_col_label.replace("col", ""))

    row_index_mapping = {
        label: int(label.replace("row", "")) - center_row_num
        for label in row_points_raw
    }
    col_points_raw = cols.get("points", {})
    col_index_mapping = {
        label: int(label.replace("col", "")) - center_col_num
        for label in col_points_raw
    }

    rows_dict = {}
    for old_label, points in validated_row_points.items():
        nri = row_index_mapping.get(old_label, 0)
        for point in points:
            ccl = closest_label(point, col_points_raw)
            nci = col_index_mapping.get(ccl, 0) if ccl else 0
            pid = (nri, nci) if id_row_major else (nci, nri)
            rows_dict.setdefault(f"row{nri}", []).append(
                {"id": pid, "x": point[0], "y": point[1]}
            )

    validated_col_points = {}
    for label, points in col_points_raw.items():
        vp = validate_points(points)
        if vp:
            validated_col_points[label] = vp

    cols_dict = {}
    for old_label, points in validated_col_points.items():
        nci = col_index_mapping.get(old_label, 0)
        for point in points:
            crl = closest_label(point, row_points_raw)
            nri = row_index_mapping.get(crl, 0) if crl else 0
            pid = (nri, nci) if id_row_major else (nci, nri)
            cols_dict.setdefault(f"col{nci}", []).append(
                {"id": pid, "x": point[0], "y": point[1]}
            )
    return rows_dict, cols_dict, center_point


# ---------------------------------------------------------------------------
# JSON assembly (ref utils/util_cylinder.py:1657-1727)


def remove_minus_labels(cols_dict):
    """ref utils/util_cylinder.py:1657-1669: drop keys starting 'col-'."""
    return {k: v for k, v in cols_dict.items() if not k.startswith("col-")}


def make_json(center_point, cols_dict):
    """ref make_json utils/util_cylinder.py:1674-1727, literal incl. the
    '(id_x, id_y)' string-regex id parse and (id_x, id_y) sort order."""
    pattern = r"\((\-?\d+),\s*(\-?\d+)\)"
    points = []
    for label, plist in cols_dict.items():
        for point in plist:
            points.append(point)
    if not points:
        raise ValueError("no valid points")
    sorted_points = []
    for point in points:
        m = re.match(pattern, str(point["id"]))
        if not m:
            raise ValueError(f"bad id {point['id']}")
        sorted_points.append((int(m.group(1)), int(m.group(2)), point))
    sorted_points.sort(key=lambda t: (t[0], t[1]))
    return json.dumps(
        {
            "center_point": list(center_point),
            "points": [
                {"id": list(p["id"]), "x": p["x"], "y": p["y"]}
                for _, _, p in sorted_points
            ],
        }
    )


# ---------------------------------------------------------------------------
# orchestration (ref color_and_expand_lines tail, utils/util_cylinder.py:2026-2055)


def detect_bookkeeping(
    h_mask: np.ndarray,
    v_mask: np.ndarray,
    centroids: np.ndarray,
    bbox,
    gray: np.ndarray,
    circle_radius0: float,
    degree: int = 2,
    prune: bool = True,
    mode: str = "cylinder",
):
    """Replay the reference bookkeeping chain from post-bridge state.

    h_mask/v_mask: FULL-resolution expanded line masks; centroids: (P, 2)
    float joint centroids (invalid rows excluded by the caller); bbox:
    (x, y, w, h) ROI bounding rect; gray: full-res grayscale image.

    Mirrors ref utils/util_cylinder.py:2026-2055: label the bbox-cropped
    masks -> group centroids -> dummy equations -> polyfit -> remove_label
    (cylinder path) -> intersections -> clean_and_relabel -> indexing ->
    remove_minus_labels -> make_json.  Returns (json_str_or_None, debug
    dict of intermediate states).
    """
    x, y, w, h = (int(v) for v in bbox)
    labels_h = label_masks(h_mask[y : y + h, x : x + w])
    labels_v = label_masks(v_mask[y : y + h, x : x + w])
    pts = [tuple(p) for p in np.asarray(centroids, float)]
    rows_g = group_points_by_label(pts, labels_h, x, y)
    cols_g = group_points_by_label(pts, labels_v, x, y)
    rows, cols = create_dummy_rows_cols(rows_g, cols_g, degree=degree)
    if mode == "plane":
        # ref util_plane.py:2820-2825: merge-capable fit, NO remove_label
        rows, cols = fit_polynomials_plane(rows, cols, degree=degree)
    else:
        rows, cols = fit_polynomials(rows, cols, degree=degree)
    if prune and mode != "plane":
        rows, cols = remove_label(rows, cols)
    rows_u, cols_u = find_and_assign_intersections(
        rows, cols, (x, y, w, h), degree=degree
    )
    rows_u, cols_u = clean_and_relabel(rows_u, cols_u)
    rows_dict, cols_dict, center_point = indexing_data(
        rows_u, cols_u, gray, circle_radius0,
        id_row_major=(mode == "plane"),
        patch_rule=mode,
    )
    debug = {
        "rows_grouped": rows_g,
        "cols_grouped": cols_g,
        "rows_dict": rows_dict,
        "cols_dict": cols_dict,
        "center_point": center_point,
    }
    if cols_dict is None:
        return None, debug
    kept = remove_minus_labels(cols_dict) if mode != "plane" else cols_dict
    if not any(kept.values()):
        return None, debug
    return make_json(center_point, kept), debug
