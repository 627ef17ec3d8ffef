"""Segmented tree-predict kernels (K1 pipelined, K2 simple) for Hopper."""
