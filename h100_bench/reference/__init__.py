"""The plain reference that decides ``correct``: MelHuBERT's and HuBERT's
forward, MelHuBERT's pre-training loss, its gradients and the Adam update,
in plain PyTorch and NumPy, float32 with TF32 off.

It follows the published models (fairseq's HuBERT and the MelHuBERT
reference) and imports nothing of the port and nothing of JAX. What the
port makes from the inputs (its checkpoint, its packed rows, its device
fbank, its masks and dropout bits) the reference works out again from the
same inputs and seeds. :mod:`.numerics` lowers the precision of every
product for the controls.
"""
