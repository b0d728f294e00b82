"""The benchmark's plain reference: the offline render (render.py) and the
streaming engine (stream.py) in plain PyTorch and NumPy, frozen copies of
the plain path for the benchmark's configurations.  Nothing here imports
the port (signalsmith_stretch_torch), JAX or the JAX package."""
