"""Dense LM layers, parameters and the model (the port of ``repro.models``)."""
