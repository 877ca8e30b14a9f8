"""Mesh construction over an initialized ``torch.distributed`` group."""
