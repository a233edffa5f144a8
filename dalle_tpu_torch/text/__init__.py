"""Text tokenizers: byte-level BPE over the CLIP vocabulary (``bpe``,
``tokenizer``), its word splitter without the ``regex`` package
(``_unicode``) and its native merge core (``native``)."""
