"""Cadenza CAD1 Task 1 recipe on the port: hearing-aid music enhancement.

The port's copy of cadenza/ (the port imports nothing of it): demix each
song with the port's Separator on `config.separator.device`, apply a
per-listener NAL-R prescription (and optionally a compressor) to each stem,
write the stems (24 kHz) and a stereo remix (32 kHz) as 16-bit WAV, score
them with HAAQI and merge the score shards. `signal_processing.py`,
`haaqi.py` and `merge_batches_results.py` are copies, NumPy/SciPy only;
`config.py` reads config.yaml without PyYAML.

    python -m xumx_slicq_torch.cadenza.enhance --config my.yaml
    python -m xumx_slicq_torch.cadenza.evaluate --config my.yaml
    python -m xumx_slicq_torch.cadenza.merge_batches_results --exp-folder /exp
"""
