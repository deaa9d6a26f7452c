"""Ops: DSP on tensors (``audio``), numpy host DSP (``vad``, ``resample``,
``mel``) and the kernel wrappers (``lstm_seq``, ``tacotron_decode``,
``wavernn_generate``). Import the submodule you need."""
