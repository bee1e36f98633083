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
  input first) and returns the block dtype.  Under a bf16 policy this is
  the ``blocks.py`` form of the JAX package, not the fold-then-apply form
  of its ``models/folded.py`` (scale and shift folded in fp32, applied in
  the input dtype); ReLU and the skip sums keep the dtype their operands
  give, as the jnp ops do (bf16 + fp32 is fp32 in both);
* every batch norm's arithmetic is ``_BiasedRunningVar``'s: the plain
  layout's, and that of the folded level-0 plan (``models/folded.py``),
  whose tensors hold a norm's channels in g fold groups (train: per-channel
  statistics over the groups too; eval without the fold below: the JAX
  package's folded form, scale and shift in fp32 applied in the input
  dtype); one helper (``_track``) moves the running statistics;
* ``_Block.forward`` runs the blocks of both plans: the folded plan hands
  it its folded convolution and the number of fold groups;
* ``takes_fold`` is where the cost count's rule is decided, the one place
  ``models/`` reads ``ops.warp_correlate.COUNTER``: under a count every
  call runs the unfolded program (no norm folded, no level folded), so
  the count is the same under every plan;
* an fp32 block whose norm runs on its running statistics, with autograd
  off and no cost count running (``takes_fold``), folds the norm into its
  convolution, in either plan: one convolution with the weight scaled
  per output channel by ``s = gamma / sqrt(running_var + eps)``
  (``eval_affine``) and the bias ``beta - running_mean * s``, then the ReLU
  (on the card in the epilogue of cuDNN's convolution where the conv is
  not transposed, else in place); the same arithmetic in fp32, rounded in
  another order (the folded plan gathers its kernel from the same scaled
  weight and tiles the bias).  The folded weight and bias are cached on
  the block, keyed on the identity, ``data_ptr`` and ``_version`` of the
  conv weight and the norm's four tensors, so ``load_state_dict``, a train
  step or ``.to()`` refreshes them.  ``fold_stats`` counts the folded and the
  unfolded calls of batch-normed blocks and the refreshes.  Training, eval
  with autograd on and the bf16 policies run the conv, the norm and the
  ReLU as above;
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
  (``dmvsnet_tpu_torch.measured_conv_algorithms``); a block's convolution
  with its norm folded in is the same problem as without.

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

from dmvsnet_tpu_torch.ops import warp_correlate
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


# calls of batch-normed blocks, folded and unfolded, and refreshes of a
# block's folded weight and bias
_FOLD_STATS = {"folded": 0, "unfolded": 0, "refreshes": 0}
_FOLD_STATS_LOCK = threading.Lock()


def fold_stats() -> dict[str, int]:
    """Since the last reset: ``folded``, the calls of batch-normed blocks
    that ran their norm folded into the convolution; ``unfolded``, those
    that ran the convolution, the norm and the ReLU; ``refreshes``, how
    often a block formed its folded weight and bias anew (once per block
    until its weights or statistics change)."""
    with _FOLD_STATS_LOCK:
        return dict(_FOLD_STATS)


def reset_fold_stats() -> None:
    with _FOLD_STATS_LOCK:
        for k in _FOLD_STATS:
            _FOLD_STATS[k] = 0


def _count_fold(key: str) -> None:
    with _FOLD_STATS_LOCK:
        _FOLD_STATS[key] += 1


def eval_affine(bn) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval batch norm as a per-channel affine map of its running
    statistics: ``(scale, shift)`` with ``bn(x) = x * scale + shift``."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return scale, bn.bias - bn.running_mean * scale


class _BiasedRunningVar:
    """Batch norm, all of its arithmetic: train mode follows the JAX
    package's running variance, ``var <- (1 - m) var + m * biased batch
    variance``.

    ``torch.nn.BatchNorm*`` normalises with the biased variance but updates
    the running variance with the unbiased one, n/(n-1) times larger (n =
    elements per channel).  At the bottom of a cost U-Net n is a few dozen
    at full size and a handful in small tests, so the factor is visible.
    The fused call updates a copy of the running variance (autograd keeps
    that copy for the backward, so the module's buffer can change in
    place), and the buffer takes the corrected update, per channel.

    With a ``process_group`` (set by ``sync_batch_norm``) the train-mode
    statistics are those of the batches of every rank in the group.

    ``g`` > 1 is a folded tensor (``models/folded.py``): (N, g*C, h, w),
    the norm's C channels in g groups, with per-C statistics over the
    groups too (train: the fp32 E[x^2] - E[x]^2, or ``group_moments`` under
    a group); its eval form is the JAX package's folded one, scale and
    shift in fp32 applied in the input's dtype.
    """

    process_group = None

    def forward(self, x: torch.Tensor, g: int = 1) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            if g == 1:
                return super().forward(x.float())
            shape = (1, -1) + (1,) * (x.dim() - 2)
            scale, shift = (t.repeat(g).to(x.dtype).view(shape) for t in eval_affine(self))
            return x * scale + shift
        x = x.float()
        if g == 1:
            self._check_input_dim(x)
            if self.process_group is None:
                return self._fused(x)
        mean, var = self._moments(x, g)
        self._track(mean, var)

        def tiled(t):
            return (t if g == 1 else t.repeat(g)).view((1, -1) + (1,) * (x.dim() - 2))

        inv = self.weight * torch.rsqrt(var + self.eps)
        return (x - tiled(mean)) * tiled(inv) + tiled(self.bias)

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode without a group: torch's fused batch norm, then the
        running variance's correction to the biased update."""
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

    def _moments(self, x: torch.Tensor, g: int):
        """Per-channel mean and biased variance of ``x`` (N, g*C, ...):
        over the joined batch of the ``process_group`` (``group_moments``),
        else E[x^2] - E[x]^2 as the JAX package's folded plan takes them."""
        c = 1 if g == 1 else 2  # the channel axis
        if g > 1:
            x = x.view(x.shape[0], g, self.num_features, *x.shape[2:])
        dims = [i for i in range(x.dim()) if i != c]
        if self.process_group is not None:
            shape = [1] * x.dim()
            shape[c] = -1
            return group_moments(x, dims, shape, self.process_group)
        mean = x.mean(dims)
        return mean, x.square().mean(dims) - mean.square()

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The batch's mean and biased variance into the running statistics
        with the momentum; a recompute under ``checkpoint`` updates
        nothing."""
        if recomputing():
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1


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

    def _cast(self, x, params=None):
        """``x`` and the weight and bias in the compute dtype; ``params``, a
        (weight, bias) pair, stands in for the module's own (a block's norm
        folded into them)."""
        dt = self.compute_dtype
        w, b = (self.weight, self.bias) if params is None else params
        return x.to(dt), w.to(dt), None if b is None else b.to(dt)

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


    def _convolve(self, fn, x: torch.Tensor, params=None, relu: bool = False) -> torch.Tensor:
        x, w, b = self._cast(x, params)
        padding = self.padding
        if self._banded():
            x, padding = self._halo(x)
        note_conv(type(self).__name__, x, w, self.stride, padding)
        return convolve(fn, x, w, b, self.stride, padding, self.dilation, self.groups, relu)


def convolve(fn, x, w, b, stride, padding, dilation, groups, relu: bool = False) -> torch.Tensor:
    """``fn`` (``F.conv{2,3}d``) of ``x`` by ``w`` and ``b``; with ``relu``,
    ReLU'd: on the card one cuDNN convolution with the bias and the ReLU in
    its epilogue (``torch.cudnn_convolution_relu``, its algorithms chosen
    under the same flags), elsewhere the ReLU in place."""
    if relu and x.is_cuda and torch.backends.cudnn.enabled:
        return torch.cudnn_convolution_relu(x, w, b, stride, padding, dilation, groups)
    y = fn(x, w, b, stride, padding, dilation, groups)
    return torch.relu_(y) if relu else y


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x: torch.Tensor, params=None, relu: bool = False) -> torch.Tensor:
        return self._convolve(F.conv2d, x, params, relu)


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x: torch.Tensor, params=None, relu: bool = False) -> torch.Tensor:
        return self._convolve(F.conv3d, x, params, relu)


class _Transpose(_Cast):
    """A transposed conv.  On a band of n rows [a, a+n) its output rows are
    [s*a, s*(a+n)); output row o takes input rows i with o = s*i + t - p,
    t < k, so (k 3, s 2, p 1) it needs input rows a..a+n: the halo row below.
    Run on the band with both halo rows and no padding on H, output row o'
    is global row o = o' + s*(a-1) - p, so the band's rows start at o' = s + p."""

    def _transpose(self, fn, x: torch.Tensor, params=None, relu: bool = False) -> torch.Tensor:
        x, w, b = self._cast(x, params)
        if not self._banded():
            note_conv(type(self).__name__, x, w, self.stride, self.padding)
            y = fn(x, w, b, self.stride, self.padding, self.output_padding, self.groups,
                   self.dilation)
        else:
            n = x.shape[-2]
            x, padding = self._halo(x)
            output_padding = list(self.output_padding)
            output_padding[-2] = 0
            note_conv(type(self).__name__, x, w, self.stride, padding)
            y = fn(x, w, b, self.stride, padding, tuple(output_padding), self.groups,
                   self.dilation)
            s = self.stride[-2]
            y = y.narrow(-2, s + self.padding[-2], s * n)
        return torch.relu_(y) if relu else y


class ConvTranspose2d(_Transpose, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor, params=None, relu: bool = False) -> torch.Tensor:
        return self._transpose(F.conv_transpose2d, x, params, relu)


class ConvTranspose3d(_Transpose, nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor, params=None, relu: bool = False) -> torch.Tensor:
        return self._transpose(F.conv_transpose3d, x, params, relu)


_CONV = {2: Conv2d, 3: Conv3d}
_DECONV = {2: ConvTranspose2d, 3: ConvTranspose3d}


def _with_dtype(conv: nn.Module, dtype: torch.dtype) -> nn.Module:
    conv.compute_dtype = dtype
    return conv


def _version(t: torch.Tensor):
    """``t``'s version counter; None for an inference tensor, which has none
    (a fold over one is formed anew on every call)."""
    return None if t.is_inference() else t._version


def _source(t: torch.Tensor) -> tuple:
    """What ``_unchanged`` compares: ``t``, its storage (held, so that its
    address is not reused while the fold is cached), ``data_ptr`` and
    version."""
    return t, t.untyped_storage(), t.data_ptr(), _version(t)


def _unchanged(source: tuple, t: torch.Tensor) -> bool:
    was, _, ptr, version = source
    return was is t and ptr == t.data_ptr() and version is not None and version == _version(t)


def takes_fold(wanted: bool) -> bool:
    """Whether a call that may take a folded form (``wanted``: a block's
    eval norm folded into its convolution, a level-0 plan's folded
    execution) takes it: not while a cost count runs
    (``ops.warp_correlate.COUNTER``), which counts the unfolded program."""
    return wanted and warp_correlate.COUNTER is None


class _Block(nn.Module):
    """conv, then batch norm (``_BiasedRunningVar``), then ReLU; an fp32
    block with autograd off folds its eval norm into the conv (``_folds``).
    Every plan runs its blocks here: ``models/folded.py`` hands ``forward``
    its folded convolution."""

    _fold = None  # (sources, folded weight, folded bias), set by _folded

    def _folds(self) -> bool:
        """Whether this call folds the norm: the norm runs on its running
        statistics, the block computes in fp32, autograd is off and no cost
        count runs (``takes_fold``)."""
        bn = self.bn
        return takes_fold(not self.training and not bn.training and bn.running_mean is not None
                          and self.dtype == torch.float32 and not torch.is_grad_enabled())

    def _folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The conv weight scaled per output channel (dim 1 of a transposed
        conv's weight) and the bias of the norm's affine map (fp32), formed
        anew when the conv weight or a tensor of the norm is another tensor,
        has other storage or was written in place since the last call."""
        conv, bn = self.conv, self.bn
        tensors = (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        if self._fold is None or not all(map(_unchanged, self._fold[0], tensors)):
            scale, shift = eval_affine(bn)
            shape = [1] * conv.weight.dim()
            shape[1 if isinstance(conv, _Transpose) else 0] = -1
            self._fold = (tuple(map(_source, tensors)), conv.weight * scale.view(shape), shift)
            _count_fold("refreshes")
        return self._fold[1:]

    def forward(self, x: torch.Tensor, conv=None, g: int = 1) -> torch.Tensor:
        """``conv(x, params=None, relu=False)`` is the convolution (the
        block's own ``self.conv`` by default; ``params``, a (weight, bias)
        pair in ``self.conv``'s layout, stands in for its parameters); its
        output holds the norm's channels in ``g`` groups."""
        conv = self.conv if conv is None else conv
        if self.bn is not None:
            if self._folds():
                _count_fold("folded")
                return conv(x, self._folded(), relu=self.relu)
            _count_fold("unfolded")
        x = conv(x)
        if self.bn is not None:
            x = self.bn(x, g)
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
    """Seeded initialisation of every conv, linear layer, batch norm and
    layer norm in ``model``.

    Convs (1-D to 3-D, transposed, and modules that sub-class them) and
    linear layers: U(+-1/sqrt(fan_in)) for weights and biases, PyTorch's
    default init (fan_in = weight.shape[1] * prod(kernel); for a linear
    layer its input width).  Batch norm (1-D to 3-D): weight 1, bias 0,
    running mean 0, running var 1.  Layer norm: weight 1, bias 0.  The
    numbers come from ``generator`` alone, on the CPU, so a seed gives the
    same weights on every device.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d, nn.Linear)):
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
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    return model
