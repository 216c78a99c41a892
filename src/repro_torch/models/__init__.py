"""The port's models (plain functions on param dicts): the LM stacks
(dense GQA, Mamba-2, MoE) and the vision models (ResNet, YOLO)."""
