"""Signal-processing operators on torch tensors, and the pick kernel's wrapper."""
