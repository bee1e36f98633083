"""backward_ms.train: device milliseconds per step in the autograd
backward (all of ``models/``, kernels 2-3), from a CUDA-event span that the
benchmark records around ``Tensor.backward`` over the traced run's window."""


def read(r):
    if r.kind != "train" or not r.units or "backward" not in r.span_ms:
        return None
    return r.span_ms["backward"] / (r.units / r.workload["batch"])
