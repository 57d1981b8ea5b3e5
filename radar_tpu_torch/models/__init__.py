"""Detection pipelines as ``nn.Module``s."""
