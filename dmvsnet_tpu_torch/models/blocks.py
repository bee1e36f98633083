"""Conv / deconv / batch-norm building blocks (port of
dmvsnet_tpu.models.blocks), channels-first as PyTorch convolutions want.

* convolutions pad k//2 on each side;
* transposed convolutions are ``ConvTranspose{2,3}d(k, stride=2,
  padding=k//2, output_padding=1)``: output exactly 2x the input;
* batch norm uses eps 1e-5 and momentum 0.1 (flax's momentum=0.9 is the
  same update written the other way round); in train mode the running
  variance is updated with the BIASED batch variance, as flax does
  (``torch.nn.BatchNorm*`` would use the unbiased one);
* a conv has a bias only when it has no batch norm;
* under data parallelism (``sync_batch_norm``) train-mode batch norm takes
  its statistics over the global batch, as flax does under jit over a
  dp-sharded batch: the mean and the biased variance of the dp group's
  joined batch, and the running variance takes the same biased update;
* a block has a compute dtype (fp32 or bf16), with the JAX package's cast
  points (``dmvsnet_tpu/models/blocks.py``): parameters stay fp32; a conv
  casts its input, weight and bias to the block dtype and returns that
  dtype; train-mode batch norm takes fp32 statistics, computes in fp32 and
  returns fp32; eval-mode batch norm computes in fp32 on the running
  statistics (flax 0.12's ``_normalize`` subtracts the fp32 mean from the
  input first) and returns the block dtype.  This is the ``blocks.py`` form
  of the JAX package, not the fold-then-apply form of its
  ``models/folded.py`` (scale and shift folded in fp32, applied in the
  input dtype); ReLU and the skip sums keep the dtype their operands give,
  as the jnp ops do (bf16 + fp32 is fp32 in both);
* on the spatial mesh axis (``spatial_split``) a 3x3 convolution inside
  ``parallel.spatial.split_rows()`` takes its input as this rank's band of
  rows: it pads the band with the halo rows of its neighbours
  (``parallel.spatial.halo_exchange``; zeros at the image's edges stand in
  for the padding on H), convolves without padding on H and returns the
  band's own output rows (for a transposed convolution, the crop that
  drops the rows the halo adds);
* ``checkpoint`` is ``torch.utils.checkpoint`` for the model's remat: a
  batch norm recomputed in the backward updates no running statistic, so
  a step updates them once, as the step without remat does.
* ``conv_selections`` counts the convolution problems the port's
  convolutions met while cuDNN chose algorithms by measurement
  (``dmvsnet_tpu_torch.measured_conv_algorithms``).

Attribute names follow the reference layout (``.conv`` and ``.bn``), so a
reference-named state dict loads as is.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from dmvsnet_tpu_torch.parallel import spatial
from dmvsnet_tpu_torch.parallel.mesh import AXIS_DATA_SPATIAL, psum

# .active is True while ``checkpoint`` recomputes a forward inside the
# backward, in the thread that runs that backward
_recomputing = threading.local()


@contextlib.contextmanager
def _recompute():
    _recomputing.active = True
    try:
        yield
    finally:
        _recomputing.active = False


def recomputing() -> bool:
    """True while ``checkpoint`` recomputes a forward in this thread: a
    batch norm then updates no running statistic."""
    return getattr(_recomputing, "active", False)


def checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): only
    the inputs are kept, and the backward runs ``fn`` again.  During that
    recompute every batch norm normalises as it did in the forward (batch
    statistics, or a synced all_reduce in the same order on every rank)
    and leaves its running statistics alone."""
    return torch_checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute()))


# the convolution problems met under measured algorithm choice
_SELECTIONS: set[tuple] = set()


def conv_selections() -> int:
    """How many distinct convolution problems (kind, input shape, weight
    shape, stride, padding, dtype, grad on or off) the port's convolutions
    (the ``_Cast`` modules and ``models/folded.py``) met while
    ``torch.backends.cudnn.benchmark`` was set, since the last reset.  On
    the card cuDNN searches once for each of them (with grad on, once more
    for each gradient of the backward) and keeps what it found for the life
    of the process; a search in a timed stretch shows as a count that moved
    in it."""
    return len(_SELECTIONS)


def reset_conv_selections() -> None:
    _SELECTIONS.clear()


def note_conv(kind: str, x: torch.Tensor, w: torch.Tensor, stride, padding) -> None:
    """Counts the problem of a convolution about to run (``conv_selections``)."""
    if torch.backends.cudnn.benchmark:
        _SELECTIONS.add((kind, tuple(x.shape), tuple(w.shape), tuple(stride), padding,
                         x.dtype, torch.is_grad_enabled()))


class _BiasedRunningVar:
    """Train-mode batch norm whose running variance follows the JAX
    package: ``var <- (1 - m) var + m * biased batch variance``.

    ``torch.nn.BatchNorm*`` normalises with the biased variance but updates
    the running variance with the unbiased one, n/(n-1) times larger (n =
    elements per channel).  At the bottom of a cost U-Net n is a few dozen
    at full size and a handful in small tests, so the factor is visible.
    The fused call updates a copy of the running variance (autograd keeps
    that copy for the backward, so the module's buffer can change in
    place), and the buffer takes the corrected update, per channel.

    With a ``process_group`` (set by ``sync_batch_norm``) the train-mode
    statistics are those of the batches of every rank in the group.
    """

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        if self.process_group is not None:
            return self._synced_forward(x)
        m = self.momentum
        var = self.running_var.clone()
        # a recompute updates copies: the same call, no buffer moves
        again = recomputing()
        mean = self.running_mean.clone() if again else self.running_mean
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m, self.eps)
        if again:
            return y
        n = x.numel() // x.shape[1]
        # torch wrote var = (1-m) old + m b n/(n-1), b the biased variance;
        # (n-1)/n var + (1-m)/n old = (1-m) old + m b
        with torch.no_grad():
            self.running_var.mul_((1.0 - m) / n).add_(var, alpha=(n - 1) / n)
            self.num_batches_tracked += 1
        return y

    def _synced_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode batch norm over the group's joined batch
        (``group_moments``)."""
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        mean, var = group_moments(x, dims, shape, self.process_group)
        y = (x - mean.view(shape)) * (torch.rsqrt(var + self.eps) * self.weight).view(shape)
        y = y + self.bias.view(shape)
        if recomputing():
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1
        return y


def group_moments(x: torch.Tensor, dims, shape, process_group):
    """Per-channel mean and biased variance of ``x`` over ``dims`` (the
    channels broadcast as ``shape``) and over the joined batch of
    ``process_group``.  Each rank puts its per-channel count, mean and sum
    of squared deviations into its row of a (ranks, 3, C) table; one
    all_reduce gives every rank the whole table, from which it combines the
    global mean and biased variance (Chan et al.'s pairwise update).
    Combining deviations avoids the cancellation of E[x^2] - E[x]^2 (flax's
    fast variance) where the mean is large against the spread.  The
    all_reduce is ``psum``: its backward sums the table's cotangents over
    the group, so the gradient of the global statistics reaches every
    rank's input."""
    mean_r = x.mean(dims)
    c = mean_r.numel()
    row = torch.stack([torch.full_like(mean_r, x.numel() // c), mean_r,
                       (x - mean_r.view(shape)).square().sum(dims)])
    k, size = dist.get_rank(process_group), dist.get_world_size(process_group)
    table = psum(torch.cat([row.new_zeros((k, 3, c)), row[None],
                            row.new_zeros((size - k - 1, 3, c))]), process_group, "batch_norm")
    counts, means, m2 = table[:, 0].detach(), table[:, 1], table[:, 2]
    count = counts.sum(0)
    mean = (counts * means).sum(0) / count
    var = (m2.sum(0) + (counts * (means - mean).square()).sum(0)) / count
    return mean, var


class BatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BiasedRunningVar, nn.BatchNorm3d):
    pass


_BN = {2: BatchNorm2d, 3: BatchNorm3d}


def sync_batch_norm(module: nn.Module, process_group) -> nn.Module:
    """Makes every batch norm of ``module`` take its train-mode statistics
    over the ranks of ``process_group`` (the dp group); None restores the
    per-process statistics.  The state dict is unchanged."""
    for m in module.modules():
        if isinstance(m, _BiasedRunningVar):
            m.process_group = process_group
    return module


def spatial_split(module: nn.Module, mesh) -> nn.Module:
    """Makes ``module`` (a cost U-Net) run on row bands over ``mesh``'s sp
    axis: within ``parallel.spatial.split_rows()`` each of its 3x3
    convolutions exchanges halo rows, and its batch norms take their
    train-mode statistics over the ``("dp", "sp")`` group, whose ranks hold
    the bands of the global batch.  Only modules that see bands: the
    feature net and the adaptive weight nets see whole maps, replicated
    over sp, and keep the dp group (``sync_batch_norm``)."""
    for m in module.modules():
        if isinstance(m, _Cast) and m.kernel_size[-2] == 3:
            m.spatial = mesh
        elif isinstance(m, _BiasedRunningVar):
            m.process_group = mesh.group(AXIS_DATA_SPATIAL)
    return module


class _Cast:
    """A conv that casts its input, weight and bias to ``compute_dtype``
    (fp32 parameters; the output in that dtype, as flax's ``dtype=``), and
    that runs on a row band where ``spatial`` (a ``parallel.Mesh``, set by
    ``spatial_split``) is set and the rows are split."""

    compute_dtype = torch.float32
    spatial = None

    def _cast(self, x):
        dt = self.compute_dtype
        return x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt)

    def _banded(self) -> bool:
        return self.spatial is not None and spatial.rows_split()

    def _halo(self, x):
        """``x`` with one halo row above and below and the padding without
        its H entry.  A 3x3 conv with padding 1 and stride s then gives the
        band's own rows: its first output is centred on the band's first row
        (s = 2: bands start on even rows, so that row is the centre of an
        output of the whole map)."""
        padding = list(self.padding)
        padding[-2] = 0
        return spatial.halo_exchange(x, self.spatial, x.dim() - 2), tuple(padding)


    def _convolve(self, fn, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._cast(x)
        padding = self.padding
        if self._banded():
            x, padding = self._halo(x)
        note_conv(type(self).__name__, x, w, self.stride, padding)
        return fn(x, w, b, self.stride, padding, self.dilation, self.groups)


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._convolve(F.conv2d, x)


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._convolve(F.conv3d, x)


class _Transpose(_Cast):
    """A transposed conv.  On a band of n rows [a, a+n) its output rows are
    [s*a, s*(a+n)); output row o takes input rows i with o = s*i + t - p,
    t < k, so (k 3, s 2, p 1) it needs input rows a..a+n: the halo row below.
    Run on the band with both halo rows and no padding on H, output row o'
    is global row o = o' + s*(a-1) - p, so the band's rows start at o' = s + p."""

    def _transpose(self, fn, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._cast(x)
        if not self._banded():
            note_conv(type(self).__name__, x, w, self.stride, self.padding)
            return fn(x, w, b, self.stride, self.padding, self.output_padding, self.groups,
                      self.dilation)
        n = x.shape[-2]
        x, padding = self._halo(x)
        output_padding = list(self.output_padding)
        output_padding[-2] = 0
        note_conv(type(self).__name__, x, w, self.stride, padding)
        y = fn(x, w, b, self.stride, padding, tuple(output_padding), self.groups, self.dilation)
        s = self.stride[-2]
        return y.narrow(-2, s + self.padding[-2], s * n)


class ConvTranspose2d(_Transpose, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._transpose(F.conv_transpose2d, x)


class ConvTranspose3d(_Transpose, nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._transpose(F.conv_transpose3d, x)


_CONV = {2: Conv2d, 3: Conv3d}
_DECONV = {2: ConvTranspose2d, 3: ConvTranspose3d}


def _with_dtype(conv: nn.Module, dtype: torch.dtype) -> nn.Module:
    conv.compute_dtype = dtype
    return conv


class _Block(nn.Module):
    """conv, then batch norm (fp32 in train; fp32 arithmetic returning the
    block dtype in eval), then ReLU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x.float())
            if not self.training:
                x = x.to(self.dtype)
        return torch.relu(x) if self.relu else x


class ConvBlock(_Block):
    """Conv{2,3}d + optional BatchNorm + optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dims: int = 2, relu: bool = True, bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _with_dtype(_CONV[dims](in_ch, out_ch, kernel, stride=stride,
                                            padding=kernel // 2, bias=not bn), dtype)
        self.bn = _BN[dims](out_ch, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu
        self.dtype = dtype


class DeconvBlock(_Block):
    """ConvTranspose{2,3}d(k, stride=2, padding=k//2, output_padding=1)
    + optional BatchNorm + optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dims: int = 2,
                 relu: bool = True, bn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _with_dtype(_DECONV[dims](in_ch, out_ch, kernel, stride=2,
                                              padding=kernel // 2, output_padding=1,
                                              bias=not bn), dtype)
        self.bn = _BN[dims](out_ch, eps=1e-5, momentum=0.1) if bn else None
        self.relu = relu
        self.dtype = dtype


def PlainConv(in_ch: int, out_ch: int, kernel: int = 1, dims: int = 2,
              use_bias: bool = False, dtype: torch.dtype = torch.float32) -> nn.Module:
    """A bare conv (no bn / relu) with k//2 padding, as the FPN heads and
    the probability heads use; output in ``dtype``."""
    return _with_dtype(_CONV[dims](in_ch, out_ch, kernel, padding=kernel // 2,
                                   bias=use_bias), dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample over the last two axes (N, C, H, W)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation of every conv and batch norm in ``model``.

    Convs: U(+-1/sqrt(fan_in)) for weights and biases, PyTorch's default
    conv init (fan_in = weight.shape[1] * prod(kernel)).  Batch norm:
    weight 1, bias 0, running mean 0, running var 1.  The numbers come
    from ``generator`` alone, on the CPU, so a seed gives the same weights
    on every device.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            bound = 1.0 / math.sqrt(m.weight.shape[1] * math.prod(m.weight.shape[2:]))
            for p in (m.weight, m.bias):
                if p is not None:
                    r = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                    p.copy_((r * 2.0 - 1.0) * bound)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            m.running_mean.fill_(0.0)
            m.running_var.fill_(1.0)
            m.num_batches_tracked.fill_(0)
    return model
