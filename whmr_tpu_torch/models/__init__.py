"""The W-HMR model graph as torch nn.Modules."""
