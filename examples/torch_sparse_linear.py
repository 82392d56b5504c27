"""Sparse linear regression on the PyTorch port, in the reference's porting
style (≙ example/sparse/linear_classification/train.py; the counterpart
of examples/sparse_linear.py): LibSVM data served as CSR batches, a dense
weight trained through `mx.nd.sparse.dot` (a gather and a segment sum on
the weight's device), SGD through autograd. Runs on the card unless
`device="cpu"` is given.

    python examples/torch_sparse_linear.py            # on the card
    python examples/torch_sparse_linear.py --cpu
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch.io import LibSVMIter  # noqa: E402
from incubator_mxnet_tpu_torch.ndarray import sparse  # noqa: E402


def make_libsvm(path, n=256, d=64, density=0.1, seed=0):
    """Synthetic zero-based libsvm file: y = x . w_true + noise (the same
    rows as examples/sparse_linear.py's for the same arguments)."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d)
    with open(path, "w") as f:
        for _ in range(n):
            nnz = max(1, rng.binomial(d, density))
            cols = np.sort(rng.choice(d, nnz, replace=False))
            vals = rng.randn(nnz)
            y = float(vals @ w_true[cols]) + 0.01 * rng.randn()
            feats = " ".join(f"{c}:{v:.5f}" for c, v in zip(cols, vals))
            f.write(f"{y:.5f} {feats}\n")
    return w_true


def step(x, y, w, b, lr, lr_b=None):
    """One SGD step of the squared loss on a CSR batch `x` (`lr_b`, the
    bias's rate, defaults to `lr`); returns the loss (an NDArray, not
    synchronised)."""
    with mx.autograd.record():
        pred = sparse.dot(x, w) + b
        loss = ((pred[:, 0] - y) ** 2).mean()
    loss.backward()
    w -= lr * w.grad
    b -= (lr if lr_b is None else lr_b) * b.grad
    return loss


def run(n=256, d=64, epochs=10, batch_size=32, lr=0.2, seed=0,
        device=None):
    """Train for `epochs` on a synthetic file; returns (the mean loss of
    each epoch, w)."""
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "train.libsvm")
    make_libsvm(path, n=n, d=d, seed=seed)
    dev = mx.device.as_device(device) if device else mx.current_device()
    with dev:
        w = mx.np.zeros((d, 1))
        b = mx.np.zeros((1,))
        w.attach_grad()
        b.attach_grad()
        losses = []
        for _ in range(epochs):
            it = LibSVMIter(path, (d,), batch_size=batch_size)  # CSR
            epoch_loss, nb = 0.0, 0
            for batch in it:
                loss = step(batch.data[0], batch.label[0], w, b, lr)
                epoch_loss += float(loss.asnumpy())
                nb += 1
            losses.append(epoch_loss / nb)
    return losses, w


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    losses, _ = run(device="cpu" if args.cpu else None)
    print("first/last epoch loss:", losses[0], losses[-1])
