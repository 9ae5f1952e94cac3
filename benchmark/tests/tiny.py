"""Tiny sizes of the cells for CPU runs (shapes only; every width is the
configuration's own at full size). f32 compute, so that a sound run's
gaps are rounding and the limits of the full-size cells separate them
from the faults."""

BERT = {"extra": ["model.vocab_size=512", "data.vocab_size=512",
                  "model.hidden_size=64", "model.num_layers=2",
                  "model.num_heads=4", "model.mlp_dim=128",
                  "model.max_seq_len=64", "model.dtype=float32"],
        "traffic": {"rows_per_chip": 4, "seq_len": 64, "token_low": 110,
                    "pool_batches": 4},
        "work": {"warm_steps": 1, "timed_warm_steps": 2, "min_steps": 12,
                 "profile_steps": 2}}

RESNET = {"extra": ["model.num_classes=10", "model.dtype=float32"],
          "traffic": {"rows_per_chip": 8, "image_size": 64,
                      "num_classes": 10, "pool_batches": 3},
          "work": {"warm_steps": 1, "timed_warm_steps": 2, "min_steps": 12,
                   "profile_steps": 2}}

CELLS = {"bert-base-mlm.s512-b96": BERT,
         "resnet50-imagenet.i224-b256": RESNET,
         "resnet50-imagenet.i224-b256-dp4": {
             **RESNET, "work": {**RESNET["work"], "chips": 2},
             "traffic": {**RESNET["traffic"], "rows_per_chip": 4}}}
SEED = 2 ** 31 + 977
