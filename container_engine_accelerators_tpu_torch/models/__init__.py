"""The LM, its decode seams and the int8 decode twin, in PyTorch."""
