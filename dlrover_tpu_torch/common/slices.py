"""Port-only: the later slices of the port, which an option of theirs names when it
raises ``NotImplementedError`` (the model zoo, the optimization library
and the mesh).  Slice 5.1, the Llama family and the chunked loss, is
``models/llama.py`` and ``models/losses.py``; slice 5.2, sequence and
expert parallelism, ``parallel/sequence.py`` and ``parallel/moe.py``."""

SLICE_5_3 = "slice 5.3 of the port (pipeline parallelism)"
SLICE_5_4 = "slice 5.4 of the port (fp8, BERT and decode attention)"
