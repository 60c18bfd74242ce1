"""Analytic FLOPs tables for the Cream supernet search space: a copy of
`cream_tpu/nas/flops.py` (pure numpy).

Rebuild of Cream/lib/utils/flops_table.py:11-76 (FlopsEst): a per-(layer,
choice) grid of MACs so the train loop can prefilter paths by FLOPs window
without running the model, and search_for_layer's per-stage depth sizing
(search_structure_supernet.py:6-44) expressed as a helper.
"""
from __future__ import annotations

import numpy as np

from cream_tpu_torch.models.cream import CHOICES, SEARCH_STAGES


def inverted_residual_macs(in_chs: int, out_chs: int, k: int, e: int,
                           stride: int, in_hw: int, se_ratio: float = 0.25
                           ) -> int:
    mid = in_chs * e
    out_hw = in_hw // stride
    macs = in_hw * in_hw * in_chs * mid                # 1x1 expand
    macs += out_hw * out_hw * mid * k * k              # depthwise kxk
    rd = max(1, int(in_chs * se_ratio))                # squeeze-excite
    macs += mid * rd * 2
    macs += out_hw * out_hw * mid * out_chs            # 1x1 project
    return macs


def build_flops_table(img_size: int = 224, stem_chs: int = 16,
                      stages=SEARCH_STAGES) -> np.ndarray:
    """(num_layers, num_choices) MACs grid for the searchable layers."""
    hw = img_size // 2          # after the stride-2 stem
    in_chs = 16                 # after the fixed ds block
    rows = []
    for chs, depth, stride in stages:
        for i in range(depth):
            s = stride if i == 0 else 1
            layer_in = in_chs if i == 0 else chs
            rows.append([inverted_residual_macs(layer_in, chs, k, e, s, hw)
                         for (k, e) in CHOICES])
            if i == 0:
                hw //= stride
        in_chs = chs
    return np.asarray(rows, np.int64)


def build_flops_op_dict(img_size: int = 224, stages=SEARCH_STAGES) -> list:
    """Per-(search-stage, choice) (first_block_macs, rest_block_macs) pairs —
    the `flops_op_dict` that search_for_layer sizes stage depths from
    (Cream/lib/utils/flops_table.py:30-76)."""
    table = build_flops_table(img_size, stages=stages)
    out = []
    row = 0
    for chs, depth, stride in stages:
        first = table[row]
        rest = table[row + 1] if depth > 1 else table[row]
        out.append([(int(first[c]), int(rest[c]))
                    for c in range(table.shape[1])])
        row += depth
    return out


def search_for_layer(flops_op_dict, flops_minimum: float, flops_maximum: float
                     ) -> tuple[list | None, int | None]:
    """Size the per-stage depths (sta_num) so the supernet's FLOPs range
    brackets [flops_minimum, flops_maximum] — exact port of
    Cream/lib/utils/search_structure_supernet.py:6-44 (the round-robin
    `order` walk growing middle stages first under per-visit `limits`,
    shrinking the input resolution when even the minimal net is too big).

    Returns (sta_num per search stage, input resolution) or (None, None)
    when the window is unsatisfiable.
    """
    sta_num = [1, 1, 1, 1, 1]
    order = [2, 3, 4, 1, 0, 2, 3, 4, 1, 0]
    limits = [3, 3, 3, 2, 2, 4, 4, 4, 4, 4]
    size_factor = 224 // 32
    base_min = sum(flops_op_dict[i][0][0] for i in range(5))
    base_max = sum(flops_op_dict[i][5][0] for i in range(5))

    if base_min > flops_maximum:
        while base_min > flops_maximum and size_factor >= 2:
            size_factor -= 1
            flops_minimum = flops_minimum * (7.0 / size_factor)
            flops_maximum = flops_maximum * (7.0 / size_factor)
        if size_factor < 2:
            return None, None
    elif base_max < flops_minimum:
        cur_ptr = 0
        while base_max < flops_minimum and cur_ptr <= 9:
            if sta_num[order[cur_ptr]] >= limits[cur_ptr]:
                cur_ptr += 1
                continue
            base_max += flops_op_dict[order[cur_ptr]][5][1]
            sta_num[order[cur_ptr]] += 1
        if cur_ptr > 7 and base_max < flops_minimum:
            return None, None

    cur_ptr = 0
    while cur_ptr <= 9:
        if sta_num[order[cur_ptr]] >= limits[cur_ptr]:
            cur_ptr += 1
            continue
        base_max += flops_op_dict[order[cur_ptr]][5][1]
        if base_max <= flops_maximum:
            sta_num[order[cur_ptr]] += 1
        else:
            break

    return sta_num, size_factor * 32


def sized_stages(sta_num, stages=SEARCH_STAGES) -> tuple:
    """Apply search_for_layer's sta_num to the stage table: same channels and
    strides, depths replaced (the reference's arch_def slicing)."""
    return tuple((chs, int(n), stride)
                 for (chs, _, stride), n in zip(stages, sta_num))


def arch_flops(arch, table: np.ndarray, base_macs: int = 40_000_000) -> int:
    """Total MACs of a path: fixed stem/head base + per-layer table lookups
    (FlopsEst.get_flops semantics; -1 layers contribute zero)."""
    total = base_macs
    for li, op in enumerate(np.asarray(arch).ravel()):
        if op >= 0:
            total += int(table[li, int(op)])
    return total
