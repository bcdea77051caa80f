"""Step builders (training and serving) and the train launcher."""
