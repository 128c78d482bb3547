"""Entry-point scripts of the PyTorch port (the serve and train CLIs) and
the step builders they share (`steps.py`)."""
