"""The example harnesses of the port, each run as ``python -m
sspv_tpu_torch.examples.<name>``: paced end-to-end latency
(``latency_bench``), N streams sharing one card (``multistream_bench``),
HTTP serving (``serve_bench``), directory and batch processing
(``process_files``, ``sharded_throughput``), VAD quality per noise
condition (``vad_eval``), the engine's npz export (``generate_samples``) and
the stability soak (``soak``).

Each takes ``--device`` (default ``cuda``, which raises without a card;
``--device cpu`` runs the plain PyTorch versions of the kernels). The
kernels build at their first launch, as everywhere in the port.
"""
