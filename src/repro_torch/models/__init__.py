"""Model code of the PyTorch port: layers, attention, the decoder LM."""
