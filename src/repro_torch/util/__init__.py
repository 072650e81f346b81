"""Helpers of the port with no JAX counterpart module (see ``util.tree``)."""
