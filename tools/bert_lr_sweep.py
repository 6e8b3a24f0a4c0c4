#!/usr/bin/env python3
"""BERT-base's training loss from random weights at several Adam rates, on
one CUDA card.

    python3 tools/bert_lr_sweep.py        # from the root of a checkout

Runs ``chip_smoke.py``'s BERT training main path (full-width ``Bert.base``,
seed 12345, hidden_dropout 0.1, ``fit(iterator)`` over BertIterator batches
of 32 at S 128 of the repository's own text, labelled by the file a line
comes from) for three epochs at each rate of RATES, and prints, one JSON
line a rate, the mean loss of every 11 steps (half an epoch). The class
prior's loss is ln 2 = 0.693: a rate whose loss settles there has learned
nothing but the prior. ``chip_smoke.py``'s BERT_TRAIN_LR is picked from
this sweep. Exits 1 without a card.
"""

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = (1e-4, 3e-5, 1e-5)
EPOCHS = 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bert_lr_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from deeplearning4j_tpu_torch.nlp import Vocab

    torch.backends.cuda.matmul.allow_tf32 = False
    text, labels = smoke.bert_corpus()
    vocab = Vocab.build(text)
    for lr in RATES:
        smoke.BERT_TRAIN_LR = lr
        net = smoke.bert_train_net(torch, num_classes=2)
        losses = []
        inner = net._gradients

        def recording(*args, **kwargs):
            out = inner(*args, **kwargs)
            losses.append(out[0])
            return out

        net._gradients = recording
        t0 = time.perf_counter()
        net.fit(smoke.bert_iterator(vocab, text, labels), epochs=EPOCHS)
        torch.cuda.synchronize()
        values = [float(v) for v in losses]
        print(json.dumps({
            "lr": lr, "epochs": EPOCHS, "steps": len(values),
            "wall_s": time.perf_counter() - t0,
            "mean_loss_per_11_steps": [
                sum(values[i:i + 11]) / len(values[i:i + 11])
                for i in range(0, len(values), 11)],
            "class_prior_loss": math.log(2.0),
            "card": torch.cuda.get_device_name(0)}), flush=True)
        del net
    return 0


if __name__ == "__main__":
    sys.exit(main())
