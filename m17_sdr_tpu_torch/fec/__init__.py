"""Forward error correction: the K=5 convolutional code and its Viterbi decoder."""
