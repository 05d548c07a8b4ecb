"""Cross-binary parity tooling against the compiled reference darknet.

``ctwin`` is a numpy transcription of the reference's integer inference
pipeline that is bit-exact to the compiled C binary; ``scripts/parity_c.py``
drives the comparison end-to-end (export checkpoint -> run reference ->
run twin + integer engine -> diff).
"""
