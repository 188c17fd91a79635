"""The scalar codecs: the bit-exact host decoders the drivers fall back to.

Copied from ``libmspack_tpu/codecs`` (the MSZIP, LZX and Quantum codecs
and what they build on) so that the port imports nothing of the JAX
package.
"""
