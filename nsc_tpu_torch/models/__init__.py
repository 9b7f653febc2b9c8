"""Encoder/decoder stacks and the codec model of the port."""
