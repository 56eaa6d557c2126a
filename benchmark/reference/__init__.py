"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch versions of the BC7 encoders and of its BC7 decoder. The comparison
that decides ``correct`` runs them on the benchmark's own blocks; nothing
here imports the program."""
