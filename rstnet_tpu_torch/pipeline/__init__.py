"""In-the-wild data pipeline (parity: DataPipeline/ + egs emilia pipeline;
counterpart of ``rstnet_tpu/pipeline``). Numpy on the host, as in the JAX
package: no stage here runs on the card."""
