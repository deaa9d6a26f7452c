"""Symbol set for text input.

Same inventory/ordering contract as the reference (ref:
synthesizer/utils/symbols.py:8-21): pad, EOS, ASCII letters, punctuation.
Index order is a checkpoint compatibility contract — embeddings are indexed
by these IDs.

This package's own copy of ``rtvc_tpu/text/symbols.py``: the port imports nothing
of the JAX package.
"""

_pad = "_"
_punctuation = "!'\"(),-.:;? "
_eos = "~"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

symbols = [_pad, _eos] + list(_characters) + list(_punctuation)

# Indices of symbols that may carry silence — used by duration prediction
# (ref: symbols.py:20-21).
silent_phonemes_indices = [
    i for i, p in enumerate(symbols) if p in _pad + _punctuation
]
