"""Compose (counterpart of ``pytorch_geometric_tpu/transforms/compose.py``;
reference: transforms.Compose, examples/faust.py:24)."""


class Compose:
    """Apply ``transforms`` one after another."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"
