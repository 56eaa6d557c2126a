"""One module per loop that a traffic mix names (``"loop"`` in its file);
``make(mix, seed, pipe, enc, opts, seconds)`` gives an object with
``levels()``, ``warm(encode)`` and ``window(encode, seconds, run)``."""
