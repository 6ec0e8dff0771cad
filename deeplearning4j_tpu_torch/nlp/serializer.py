"""Word-vector serialization: text, word2vec-binary, and zip formats.

Parity: models/embeddings/loader/WordVectorSerializer.java
(writeWordVectors / loadTxtVectors -> text "word v1 v2 ...";
readBinaryModel/writeBinary -> the original word2vec .bin layout
"V D\\n" + per-word "word " + D float32s; writeWord2VecModel zip with
vocab + vectors). Trained embeddings can leave the process in formats the
original word2vec / gensim / the reference all read.

A host copy of the JAX package's module: both packages write the same
files byte for byte (the zip's ``format`` tag included) and read each
other's.
"""

from __future__ import annotations

import json
import struct
import zipfile
from typing import TYPE_CHECKING, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

if TYPE_CHECKING:  # pragma: no cover
    from deeplearning4j_tpu_torch.nlp.embeddings import SequenceVectors, StaticWord2Vec


def _vocab_and_vectors(model) -> Tuple[VocabCache, np.ndarray]:
    vocab = model.vocab
    vectors = np.asarray(model.syn0, np.float32)
    if vocab is None or len(vocab) != vectors.shape[0]:
        raise ValueError("model has no vocab or vocab/vector size mismatch")
    return vocab, vectors


class WordVectorSerializer:
    # -- text format -------------------------------------------------------
    @staticmethod
    def write_word_vectors(model, path: str) -> None:
        """One line per word: ``word v1 v2 ... vD`` (writeWordVectors)."""
        vocab, vectors = _vocab_and_vectors(model)
        with open(path, "w", encoding="utf-8") as f:
            for i in range(len(vocab)):
                vec = " ".join(f"{v:.6g}" for v in vectors[i])
                f.write(f"{vocab.word_at(i)} {vec}\n")

    @staticmethod
    def load_txt_vectors(path: str) -> "StaticWord2Vec":
        """Reads text format (with or without a leading "V D" header line)."""
        from deeplearning4j_tpu_torch.nlp.embeddings import StaticWord2Vec

        words, rows = [], []
        with open(path, encoding="utf-8") as f:
            first = f.readline().rstrip("\n")
            parts = first.split(" ")
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                pass  # header line, skip
            elif parts:
                words.append(parts[0])
                rows.append([float(v) for v in parts[1:]])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                rows.append([float(v) for v in parts[1:]])
        vocab = VocabCache()
        for w in words:
            vocab.add(VocabWord(w))
        return StaticWord2Vec(vocab, np.asarray(rows, np.float32))

    # -- word2vec binary ---------------------------------------------------
    @staticmethod
    def write_binary(model, path: str) -> None:
        """Original word2vec .bin layout (readBinaryModel's inverse)."""
        vocab, vectors = _vocab_and_vectors(model)
        V, D = vectors.shape
        with open(path, "wb") as f:
            f.write(f"{V} {D}\n".encode("utf-8"))
            for i in range(V):
                f.write(vocab.word_at(i).encode("utf-8") + b" ")
                f.write(vectors[i].astype("<f4").tobytes())
                f.write(b"\n")

    @staticmethod
    def read_binary(path: str) -> "StaticWord2Vec":
        from deeplearning4j_tpu_torch.nlp.embeddings import StaticWord2Vec

        with open(path, "rb") as f:
            header = b""
            while not header.endswith(b"\n"):
                header += f.read(1)
            V, D = (int(t) for t in header.decode("utf-8").split())
            vocab = VocabCache()
            vectors = np.empty((V, D), np.float32)
            for i in range(V):
                word = b""
                while True:
                    c = f.read(1)
                    if c in (b" ", b""):
                        break
                    if c != b"\n":  # leading newline from previous row
                        word += c
                vocab.add(VocabWord(word.decode("utf-8")))
                vectors[i] = np.frombuffer(f.read(4 * D), dtype="<f4")
        return StaticWord2Vec(vocab, vectors)

    # -- zip container -----------------------------------------------------
    @staticmethod
    def write_word2vec_model(model, path: str) -> None:
        """Zip with vectors.bin + vocab.json (+ counts), the
        writeWord2VecModel container capability."""
        vocab, vectors = _vocab_and_vectors(model)
        meta = {
            "format": "deeplearning4j_tpu/word2vec",
            "version": 1,
            "vocab": [
                {"word": vocab.word_at(i), "count": int(vocab.word_for(vocab.word_at(i)).count)}
                for i in range(len(vocab))
            ],
            "layer_size": int(vectors.shape[1]),
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("metadata.json", json.dumps(meta))
            z.writestr("syn0.npy", _npy_bytes(vectors))

    @staticmethod
    def read_word2vec_model(path: str) -> "StaticWord2Vec":
        from deeplearning4j_tpu_torch.nlp.embeddings import StaticWord2Vec
        import io

        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("metadata.json"))
            vectors = np.load(io.BytesIO(z.read("syn0.npy")))
        vocab = VocabCache()
        for entry in meta["vocab"]:
            vocab.add(VocabWord(entry["word"], count=entry.get("count", 1)))
        return StaticWord2Vec(vocab, vectors)


def _npy_bytes(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()
