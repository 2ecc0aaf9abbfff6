"""The port's float64 ground truth (numpy_oracle.py): a scalar recursion of
the full transport that replays the renderer's own uniforms."""
