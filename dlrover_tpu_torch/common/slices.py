"""Port-only: the later slices of the port, which an option of theirs names when it
raises ``NotImplementedError`` (the model zoo and the remat policies).
Slice 5.1, the Llama family and the chunked loss, is ``models/llama.py``
and ``models/losses.py``; slice 5.2, sequence and expert parallelism,
``parallel/sequence.py`` and ``parallel/moe.py``; slice 5.3, pipeline
parallelism and fp8 matmuls, ``parallel/pipeline.py`` (with the
pipelined GPT and Llama of ``models/``) and ``ops/fp8.py``."""

SLICE_5_4 = ("slice 5.4 of the port (BERT, decode attention and the "
             "save_attn remat policy)")
