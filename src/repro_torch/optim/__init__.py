"""The optimizer (``adamw``) and gradient compression (``compression``),
as plain functions on tensors."""
