"""LSTM word language model on the PyTorch port (the port's counterpart of
examples/word_language_model.py, which follows the MXNet reference's
example/gluon/word_language_model/train.py).

Trains an embedding -> multi-layer LSTM -> dense (optionally tied to the
embedding) language model with truncated BPTT on a local text corpus, or
on a synthetic Zipf corpus when none is given, through either of the
example's loops: the fused step (`FusedTrainStep`: forward, loss,
backward, global-norm clipping and SGD in one call) or, with --no-fused,
the imperative loop (`record()`, `backward()`, `npx.clip_by_global_norm`,
`Trainer.step`). Each time step of the LSTM runs the port's recurrent cell
kernel on the card (`ops/csrc/rnn_cell.cu`).

    python examples/torch_word_language_model.py [--data file.txt]
        [--epochs 1] [--no-fused] [--device cpu]
    # the reference's medium model on a WikiText-2-sized vocabulary:
    python examples/torch_word_language_model.py --emsize 650 --nhid 650 \\
        --dropout 0.5 --tied --vocab 33278 --lr 20

It imports only the port (`incubator_mxnet_tpu_torch`).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import argparse
import math
import time

import numpy as np

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon
from incubator_mxnet_tpu_torch import optimizer as opt_mod
from incubator_mxnet_tpu_torch.gluon import nn, rnn
from incubator_mxnet_tpu_torch.gluon.contrib import FusedTrainStep


class RNNModel(gluon.HybridBlock):
    """≙ the reference example's RNNModel (embed → LSTM → tied dense)."""

    def __init__(self, vocab_size, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.2, tie_weights=False):
        super().__init__()
        self.drop = nn.Dropout(dropout)
        self.encoder = nn.Embedding(vocab_size, embed_size)
        self.rnn = rnn.LSTM(hidden_size, num_layers, dropout=dropout,
                            input_size=embed_size)
        self.decoder = nn.Dense(vocab_size, in_units=hidden_size)
        if tie_weights:
            if embed_size != hidden_size:
                raise ValueError("tie_weights needs embed_size == hidden_size")
            self.decoder.weight = self.encoder.weight  # shared Parameter
        self.hidden_size = hidden_size

    def forward(self, inputs, h, c):
        emb = self.drop(self.encoder(inputs))          # (T, N, E)
        output, state = self.rnn(emb, [h, c])
        output = self.drop(output)
        decoded = self.decoder(output.reshape((-1, self.hidden_size)))
        return decoded, state[0], state[1]

    def begin_state(self, batch_size):
        return self.rnn.begin_state(batch_size)


def batchify(ids, batch_size):
    nbatch = len(ids) // batch_size
    data = np.asarray(ids[:nbatch * batch_size], np.int32)
    return data.reshape(batch_size, nbatch).T  # (T, N)


def zipf_corpus(vocab, n_tokens, seed=0):
    """The example's synthetic corpus: Zipf-distributed draws folded into a
    learnable bigram structure, id_t = (31 id_{t-1} + draw_t) mod vocab."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    draws = rng.choice(vocab, size=n_tokens, p=p)
    ids = np.empty(n_tokens + 1, np.int64)
    ids[0] = 0
    for t in range(n_tokens):
        ids[t + 1] = (ids[t] * 31 + draws[t]) % vocab
    return ids.astype(np.int32)


def get_corpus(path, vocab=2000, n_tokens=200000):
    if not path:
        print("no --data given; generating synthetic Zipf corpus")
        return zipf_corpus(vocab, n_tokens), vocab
    with open(path) as f:
        words = f.read().replace("\n", " <eos> ").split()
    uniq = sorted(set(words))
    index = {w: i for i, w in enumerate(uniq)}
    return np.asarray([index[w] for w in words], np.int32), len(uniq)


def sum_loss(loss_fn):
    """The example's objective: the backward of the unreduced per-token
    loss (its sum); the optimizer's 1/batch rescale then makes it
    mean_loss * bptt."""
    def fn(net, x, y, h, c):
        out, h2, c2 = net(x, h, c)
        return loss_fn(out, y).sum(), h2, c2
    return fn


def fused_step(model, loss_fn, lr, clip, batch_size):
    """The whole truncated-BPTT step (forward, loss, backward, clipping at
    clip * batch_size, SGD with rescale 1/batch_size) as one call."""
    opt = opt_mod.create("sgd", learning_rate=lr,
                         rescale_grad=1.0 / batch_size)
    return FusedTrainStep(model, sum_loss(loss_fn), opt,
                          clip_global_norm=clip * batch_size)


def imperative_step(model, loss_fn, trainer, clip, batch_size, x, y, h, c):
    """One step of the example's --no-fused loop; returns (summed loss,
    h, c), the states detached for the next step."""
    h, c = h.detach(), c.detach()
    with mx.autograd.record():
        out, h, c = model(x, h, c)
        L = loss_fn(out, y).sum()
    L.backward()
    grads = [p.grad() for p in model.collect_params().values()
             if p.grad_req != "null"]
    mx.npx.clip_by_global_norm(grads, clip * batch_size)
    trainer.step(batch_size)
    return L, h, c


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--bptt", type=int, default=35)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--clip", type=float, default=0.25)
    ap.add_argument("--emsize", type=int, default=200)
    ap.add_argument("--nhid", type=int, default=200)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--tied", action="store_true")
    ap.add_argument("--vocab", type=int, default=2000,
                    help="the synthetic corpus's vocabulary")
    ap.add_argument("--tokens", type=int, default=200000,
                    help="the synthetic corpus's length")
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--no-fused", action="store_true",
                    help="use the imperative tape loop instead of the "
                         "fused step")
    args = ap.parse_args()

    dev = mx.device.resolve_device(args.device)
    ids, vocab = get_corpus(args.data, args.vocab, args.tokens)
    data = batchify(ids, args.batch_size)
    print(f"corpus: {len(ids)} tokens, vocab {vocab}, "
          f"{data.shape[0]} time steps")

    model = RNNModel(vocab, args.emsize, args.nhid, args.nlayers,
                     args.dropout, args.tied)
    model.initialize(init="xavier", device=dev)
    model.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if args.no_fused:
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": args.lr})
    else:
        step = fused_step(model, loss_fn, args.lr, args.clip,
                          args.batch_size)

    for epoch in range(args.epochs):
        h, c = model.begin_state(args.batch_size)
        losses, n_batches = [], 0
        t0 = time.time()
        for i in range(0, data.shape[0] - 1 - args.bptt, args.bptt):
            if args.max_batches is not None and n_batches >= args.max_batches:
                break
            x = mx.np.array(data[i:i + args.bptt], device=dev)
            y = mx.np.array(data[i + 1:i + 1 + args.bptt].reshape(-1),
                            device=dev)
            n_tok = args.bptt * args.batch_size
            if args.no_fused:
                L, h, c = imperative_step(model, loss_fn, trainer, args.clip,
                                          args.batch_size, x, y, h, c)
            else:
                L, h, c = step(x, y, h, c)
            losses.append(L / n_tok)
            n_batches += 1
        if losses:
            losses[-1].wait_to_read()
        dt = time.time() - t0
        total_loss = float(sum(float(v.asnumpy()) for v in losses))
        ppl = math.exp(total_loss / max(n_batches, 1))
        tok_s = n_batches * args.bptt * args.batch_size / dt
        print(f"epoch {epoch}: perplexity={ppl:.1f} ({tok_s:.0f} tokens/s)")


if __name__ == "__main__":
    main()
