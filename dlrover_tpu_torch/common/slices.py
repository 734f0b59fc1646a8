"""Port-only: the later slices of the port, which an option of theirs names when it
raises ``NotImplementedError`` (the model zoo and the remat policies).
Slice 5.1, the Llama family and the chunked loss, is ``models/llama.py``
and ``models/losses.py``; slice 5.2, sequence and expert parallelism,
``parallel/sequence.py`` and ``parallel/moe.py``; slice 5.3, pipeline
parallelism and fp8 matmuls, ``parallel/pipeline.py`` (with the
pipelined GPT and Llama of ``models/``) and ``ops/fp8.py``; slice 7,
the RL engine with the KV-cache decode of 5.4, ``rl/`` (and the decode
paths of ``models/``)."""

SLICE_5_4 = ("slice 5.4 of the port (BERT and the save_attn remat "
             "policy)")
SLICE_8_2 = ("slice 8.2 of the port (the compile cache and the AOT "
             "executable cache)")
