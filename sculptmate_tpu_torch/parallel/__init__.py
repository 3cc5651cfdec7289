"""Batched serving on one card (``farm.AssetFarm``)."""
