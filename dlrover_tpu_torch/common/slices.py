"""Port-only: the later slices of the port, which an option of theirs names when it
raises ``NotImplementedError``.  Slice 5.1, the Llama family and the
chunked loss, is ``models/llama.py`` and ``models/losses.py``; slice
5.2, sequence and expert parallelism, ``parallel/sequence.py`` and
``parallel/moe.py``; slice 5.3, pipeline parallelism and fp8 matmuls,
``parallel/pipeline.py`` (with the pipelined GPT and Llama of
``models/``) and ``ops/fp8.py``; slice 5.4, ``models/bert.py`` and
GPT's save_attn remat policy (with the KV-cache decode, which came
with slice 7, the RL engine of ``rl/``)."""

SLICE_8_2 = ("slice 8.2 of the port (the compile cache and the AOT "
             "executable cache)")
