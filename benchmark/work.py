"""The yardstick's arithmetic: the card's published peaks and the work of
the hand-written kernels' sites, counted from the sites' shapes.

Each input is counted read once and each output written once, whatever a
kernel reads again (frozen copies of ``chip_smoke.py``'s ``_blur_bytes``,
``_apply_bytes`` and ``_fused_bytes``), so a later kernel that implements
a site is read against the same work.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
PEAKS = {"H100": {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12}}


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    return next((v for k, v in PEAKS.items() if k in kind), None)


def blur_bytes(n, h, w, c, itemsize=2):
    """BlurPool 3x3/2 at an input of N x H x W x C: the input read and the
    output written once (the backward moves as many the other way)."""
    return (n * h * w * c + n * ((h + 1) // 2) * ((w + 1) // 2) * c) * itemsize


def apply_bytes(n, h, w, c, itemsize=2):
    """The DropBlock apply: the activation in and out once, the fp32 mask
    and the N fp32 counts read once."""
    return 2 * n * h * w * c * itemsize + n * h * w * 4 + n * 4


def fused_bytes(n, h, w, c, itemsize=2):
    """DropBlock's mask drawn and applied: the activation in and out once,
    the N int32 seeds read, the fp32 mask and the N fp32 counts written."""
    return 2 * n * h * w * c * itemsize + n * 4 + n * h * w * 4 + n * 4


def handk_sites(model: dict, image_size: int) -> list:
    """The sites of the hand-written kernels in one training forward:
    ``("blur", h, w, c)`` at each strided block's middle (its input's
    size), ``("dropblock", h, w, c)`` after each block of the DropBlock
    stages."""
    from benchmark.reference.model import BLOCKS, EXPANSION, stage_filters

    sites, hw = [], image_size // 4
    for s, n in enumerate(BLOCKS[model["resnet_size"]]):
        f = stage_filters(model, s)
        if s > 0:
            if model["anti_alias_type"] == "sconv":
                sites.append(("blur", hw, hw, f))
            hw = (hw + 1) // 2
        if model["use_dropblock"] and s + 1 in model["dropblock_stages"]:
            sites += [("dropblock", hw, hw, f * EXPANSION)] * n
    return sites


def handk_step_bytes(model: dict, image_size: int, n: int, itemsize: int = 2) -> int:
    """The sites' bytes in one training step of ``n`` images a card: each
    blur forward and backward, each DropBlock site's drawn-and-applied
    forward and its apply backward."""
    total = 0
    for kind, h, w, c in handk_sites(model, image_size):
        if kind == "blur":
            total += 2 * blur_bytes(n, h, w, c, itemsize)
        else:
            total += fused_bytes(n, h, w, c, itemsize) + apply_bytes(n, h, w, c, itemsize)
    return total
