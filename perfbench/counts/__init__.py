"""Operation and byte counts from shapes: one file an architecture
(`<arch>.py`: its forward FLOPs), one an algorithm (`<algo>.py`: the FLOPs
an image of its training step), one a hand kernel (`<kernel>.py`: its
bytes and float operations). Matrix products and convolutions count 2
FLOPs a multiply-add."""
