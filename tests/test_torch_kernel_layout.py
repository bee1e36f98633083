"""What the warp-correlate kernels' launches rely on, checked on the CPU (the
kernels themselves build and run only on the card): every channel count the
wrappers accept has an instantiation in each CUDA source, and the forward
refuses images whose pixel index does not fit the tap code it passes
between lanes.
"""

import re
from pathlib import Path

import pytest
import torch

from dmvsnet_tpu_torch.ops import warp_correlate as twc

CSRC = Path(twc.__file__).resolve().parents[1] / "csrc"
SOURCES = ("warp_correlate.cu", "warp_correlate_grad_ref.cu", "warp_correlate_grad_src.cu")


@pytest.mark.parametrize("source", SOURCES)
def test_every_channel_count_is_instantiated(source):
    """The C entry point dispatches each C of twc.CHANNELS to a template
    instance (any other C returns cudaErrorInvalidValue at launch); the
    forward also has its planes per lane group for each."""
    text = (CSRC / source).read_text()
    entry = text[text.index('extern "C"'):]
    assert sorted(int(c) for c in re.findall(r"case (\d+):", entry)) == list(twc.CHANNELS)
    if source == "warp_correlate.cu":
        planes = re.findall(r"template <> struct Planes<(\d+)> \{ static constexpr int P = (\d+);",
                            text)
        assert sorted(int(c) for c, _ in planes) == list(twc.CHANNELS)
        assert all(int(p) >= 1 for _, p in planes)


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
