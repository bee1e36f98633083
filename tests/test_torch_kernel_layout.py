"""What the kernels' launches rely on, checked on the CPU (the kernels
themselves build and run only on the card): every channel count the
wrappers accept has an instantiation in each CUDA source whose wrapper
takes only those counts, the per-C lane constants divide a warp and cover
C, and the kernels that pass a tap code between lanes refuse images whose
pixel index does not fit it.
"""

import re
from pathlib import Path

import pytest
import torch

from dmvsnet_tpu_torch.ops import warp_correlate as twc

CSRC = Path(twc.__file__).resolve().parents[1] / "csrc"
SOURCES = ("warp_correlate.cu", "warp_correlate_grad_ref.cu", "warp_correlate_grad_src.cu",
           "sweep1d.cu")


@pytest.mark.parametrize("source", SOURCES)
def test_every_channel_count_is_instantiated(source):
    """The C entry point dispatches each C of twc.CHANNELS (which the
    sweep's wrapper also takes) to a template instance (any other C returns
    cudaErrorInvalidValue at launch); the forward also has its planes per
    lane group for each."""
    text = (CSRC / source).read_text()
    entry = text[text.index('extern "C"'):]
    assert sorted(int(c) for c in re.findall(r"case (\d+):", entry)) == list(twc.CHANNELS)
    if source == "warp_correlate.cu":
        planes = re.findall(r"template <> struct Planes<(\d+)> \{ static constexpr int P = (\d+);",
                            text)
        assert sorted(int(c) for c, _ in planes) == list(twc.CHANNELS)
        assert all(int(p) >= 1 for _, p in planes)


def _specialisations(text: str, struct: str) -> dict[int, dict[str, int]]:
    """{C: {name: value}} of ``template <> struct <struct><C> { static
    constexpr int a = .., b = ..; };``"""
    found = {}
    for c, body in re.findall(r"template <> struct " + struct + r"<(\d+)> \{ static constexpr "
                              r"int ([^;]*);", text):
        found[int(c)] = {k.strip(): int(v) for k, v in (kv.split("=") for kv in body.split(","))}
    return found


@pytest.mark.parametrize("source,struct", [("sweep1d.cu", "Run"),
                                          ("warp_correlate_grad_ref.cu", "Planes")])
@pytest.mark.parametrize("channels", twc.CHANNELS)
def test_lane_constants_divide_a_warp_and_cover_c(source, struct, channels):
    """The lane-group kernels put a pixel's C channels on L lanes of F
    float4s each (the reference gradient: F = 1): L * F float4s cover C and
    L divides a warp, so a pixel's lanes never straddle two warps.  A run of
    P planes is at least one plane, and in the sweep a multiple of L (its
    reduce-scatter leaves each lane P/L whole planes)."""
    text = (CSRC / source).read_text()
    const = _specialisations(text, struct)[channels]
    f = const.get("F", 1)
    assert ("constexpr int L = C4 / F;" if "F" in const else "constexpr int L = C / 4;") in text
    lanes = channels // 4 // f
    assert 4 * f * lanes == channels and 32 % lanes == 0
    assert const["P"] >= 1
    if struct == "Run":
        assert const["P"] % lanes == 0


@pytest.mark.parametrize("h,w,refused", [
    (1 << 15, 1 << 14, True),
    (1 << 29, 1, True),
    ((1 << 29) - 1, 1, False),
])
def test_forward_refuses_pixels_past_the_tap_code(h, w, refused):
    """The forward packs a tap's pixel index shifted left by 2 into an int:
    H*W >= 2^29 is refused before anything is allocated or launched.  Below
    that the autograd Function goes on to the launch, which refuses CPU
    tensors.  Zero-stride inputs and no planes keep the tensors empty."""
    feats = torch.zeros(1, 1, 1, 1, 1).expand(1, 2, h, w, 8)
    rel = torch.zeros(1, 1, 3, 4)
    depth = torch.zeros(1, 0, h, w)
    match = "packs a tap's pixel index" if refused else "unsupported device"
    with pytest.raises(ValueError, match=match):
        twc._WarpCorrelate.apply(feats, rel, depth)


@pytest.mark.parametrize("h,w,refused", [
    (1 << 15, 1 << 14, True),
    ((1 << 29) - 1, 1, False),
])
def test_reference_gradient_refuses_pixels_past_the_tap_code(h, w, refused):
    """The reference-gradient kernel passes the same tap code between lanes:
    off the CPU its wrapper refuses H*W >= 2^29 before it allocates; below
    that it goes on to the launch, which refuses a device that is not CUDA
    (meta tensors stand in for the card's)."""
    feats = torch.zeros(1, 1, 1, 1, 1, device="meta").expand(1, 2, h, w, 8)
    rel = torch.zeros(1, 1, 3, 4, device="meta")
    depth = torch.zeros(1, 0, h, w, device="meta")
    cot = torch.zeros(1, 0, h, w, 2, device="meta")
    match = "packs a tap's pixel index" if refused else "unsupported device"
    with pytest.raises(ValueError, match=match):
        twc.warp_correlate_grad_ref(feats, rel, depth, cot)
