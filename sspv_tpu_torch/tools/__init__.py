"""Measurement tools of the port, each run as ``python -m
sspv_tpu_torch.tools.<name>``: the soak's log report and segment stitcher
(``soak_report``, ``soak_stitch``, driven by ``run_soak.sh`` in this
folder), per-call amortization probes of features+VAD and of the pitch
track against the signal length (``length_probe``, ``pitch_probe``), and a
fuzz of VAD configurations and frame geometries against the NumPy oracle
(``deep_fuzz``). The probes and the fuzz take ``--device`` (default
``cuda``, which raises without a card).
"""
