"""Word2Vec and the embedding libraries (the PyTorch port of ``nlp/``).

Host modules (tokenizers, CJK segmentation, vocab and Huffman tables,
vectorizers, the serializer) are copies of the JAX package's; the
trainers (``embeddings``, ``glove``, ``distributed``) keep its classes,
signatures and host RNG streams and run their batched steps as plain
PyTorch on the model's device (the GPU unless ``device="cpu"``).
"""
