"""Spherical gaussians lighting: GGX specular + diffuse (DIB-R++).

Parity: ``kaolin/render/lighting/sg.py`` (reference).

Note: the reference ships a fused CUDA kernel for
``unbatched_reduced_sg_inner_product`` (``csrc/render/sg/
unbatched_reduced_sg_inner_product_cuda.cu``) because the broadcast + sum
materializes ``(num_sg, num_other, 3)`` in torch.  In XLA the broadcast,
elementwise math and the reduction fuse into a single pass over the output,
so the plain jnp formulation *is* the fused kernel; both public entry points
here share one implementation (no >=8 lobe threshold needed, gradients are
exact via autodiff).
"""

import math

import jax
import jax.numpy as jnp

__all__ = [
    'sg_distribution_term',
    'sg_warp_distribution',
    'sg_warp_specular_term',
    'cosine_lobe_sg',
    'approximate_sg_integral',
    'sg_irradiance_fitted',
    'sg_diffuse_fitted',
    'sg_irradiance_inner_product',
    'sg_diffuse_inner_product',
    'unbatched_sg_inner_product',
    'unbatched_reduced_sg_inner_product',
    'fresnel',
]


def _dot(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def _reflect(direction, normal):
    return direction - 2 * _dot(direction, normal) * normal


def _ggx_v1(m2, n_dot_x):
    """Smith visibility helper for the GGX distribution (reference :46)."""
    return 1. / (n_dot_x + jnp.sqrt(m2 + (1. - m2) * n_dot_x * n_dot_x))


def fresnel(ldh, spec_albedo):
    """Schlick fresnel (reference :120)."""
    pow_term = (1. - ldh) ** 5
    return spec_albedo + (1. - spec_albedo) * pow_term


def sg_distribution_term(direction, roughness):
    """Single-lobe SG approximation of the GGX NDF (reference :51).

    Args:
        direction: ``(N, 3)`` normals.
        roughness: ``(N,)``.

    Returns:
        (amplitude ``(N, 3)``, direction, sharpness ``(N,)``).
    """
    m2 = roughness * roughness
    sharpness = 2. / m2
    amplitude = jnp.broadcast_to(
        (1. / (math.pi * m2))[:, None], direction.shape)
    return amplitude, direction, sharpness


def sg_warp_distribution(amplitude, direction, sharpness, view):
    """Warp an NDF SG into the BRDF slice along the view (reference :81)."""
    warp_direction = _reflect(-view, direction)
    warp_sharpness = sharpness / (
        4. * jnp.clip(_dot(direction, view)[..., 0], 1e-4, None))
    return amplitude, warp_direction, warp_sharpness


def cosine_lobe_sg(direction):
    """Clamped-cosine lobe approximated as an SG (reference :184)."""
    amplitude = jnp.full_like(direction, 1.17)
    sharpness = jnp.full_like(direction[:, 0], 2.133)
    return amplitude, direction, sharpness


def approximate_sg_integral(amplitude, sharpness):
    """Approximate full-sphere SG integral (reference :205)."""
    return 2. * math.pi * (amplitude / sharpness[..., None])


def unbatched_sg_inner_product(amplitude, direction, sharpness,
                               other_amplitude, other_direction,
                               other_sharpness):
    """SG inner product, all lhs x rhs pairs (reference :392).

    Returns:
        ``(num_sg, num_other, 3)``.
    """
    a = amplitude[:, None]            # (S, 1, 3)
    d = direction[:, None]
    s = sharpness[:, None, None]
    oa = other_amplitude[None]        # (1, O, 3)
    od = other_direction[None]
    os_ = other_sharpness[None, :, None]
    dm_vec = s * d + os_ * od
    dm = jnp.sqrt(_dot(dm_vec, dm_vec))
    lm = s + os_
    expo = jnp.exp(dm - lm) * (a * oa)
    other = 1.0 - jnp.exp(-2.0 * dm)
    return 2.0 * math.pi * expo * other / dm


def unbatched_reduced_sg_inner_product(amplitude, direction, sharpness,
                                       other_amplitude, other_direction,
                                       other_sharpness):
    """Fused ``unbatched_sg_inner_product(...).sum(1)`` (reference :472).

    XLA fuses the broadcast and reduction, matching the reference's custom
    CUDA kernel without a separate code path.

    Returns:
        ``(num_sg, 3)``.
    """
    return unbatched_sg_inner_product(
        amplitude, direction, sharpness,
        other_amplitude, other_direction, other_sharpness).sum(axis=1)


def sg_warp_specular_term(amplitude, direction, sharpness, normal,
                          roughness, view, spec_albedo):
    """Cook-Torrance specular reflectance from SG radiance (reference :124).

    Args:
        amplitude / direction / sharpness: incoming-radiance SGs (per point).
        normal: ``(N, 3)``; roughness ``(N,)``; view ``(N, 3)``;
        spec_albedo ``(N, 3)``.

    Returns:
        ``(N, 3)`` specular reflectance.
    """
    ndf_amplitude, ndf_direction, ndf_sharpness = sg_distribution_term(
        normal, roughness)
    ndf_amplitude, ndf_direction, ndf_sharpness = sg_warp_distribution(
        ndf_amplitude, ndf_direction, ndf_sharpness, view)
    ndl = jnp.clip(_dot(normal, ndf_direction), 0., 1.)
    ndv = jnp.clip(_dot(normal, view), 0., 1.)
    h = ndf_direction + view
    h = h / jnp.sqrt(_dot(h, h))
    ldh = jnp.clip(_dot(ndf_direction, h), 0., 1.)

    output = unbatched_reduced_sg_inner_product(
        ndf_amplitude, ndf_direction, ndf_sharpness,
        amplitude, direction, sharpness)
    m2 = (roughness * roughness)[:, None]
    output = output * _ggx_v1(m2, ndl) * _ggx_v1(m2, ndv)
    output = output * fresnel(ldh, spec_albedo)
    output = output * ndl
    return jnp.clip(output, 0., None)


def sg_irradiance_fitted(amplitude, direction, sharpness, normal):
    """Irradiance via Stephen Hill's fitted polynomial (reference :220).

    Returns:
        ``(num_points, num_sg, 3)``.
    """
    mu_n = jnp.einsum('ik,jk->ij', normal, direction)  # (N, S)
    lbda = sharpness[None, :]

    c0 = 0.36
    c1 = 1. / (4. * c0)
    eml = jnp.exp(-lbda)
    em2l = eml * eml
    rl = 1. / lbda
    scale = 1. + 2. * em2l - rl
    bias = (eml - em2l) * rl - em2l
    x = jnp.sqrt(1. - scale)
    x0 = c0 * mu_n
    x1 = c1 * x
    n = x0 + x1
    y = jnp.where(jnp.abs(x0) <= x1, n * n / x, jnp.clip(mu_n, 0., 1.))
    result = scale * y + bias
    return result[..., None] * approximate_sg_integral(
        amplitude, sharpness)[None]


def sg_diffuse_fitted(amplitude, direction, sharpness, normal, albedo):
    """Lambertian diffuse radiance via fitted irradiance (reference :279)."""
    brdf = albedo / math.pi
    return jnp.clip(
        sg_irradiance_fitted(amplitude, direction, sharpness,
                             normal).mean(axis=1), 0., None) * brdf


def sg_irradiance_inner_product(amplitude, direction, sharpness, normal):
    """Irradiance via cosine-lobe SG inner product (reference :318)."""
    lobe_amplitude, lobe_direction, lobe_sharpness = cosine_lobe_sg(normal)
    return jnp.clip(unbatched_reduced_sg_inner_product(
        lobe_amplitude, lobe_direction, lobe_sharpness,
        amplitude, direction, sharpness), 0., None)


def sg_diffuse_inner_product(amplitude, direction, sharpness, normal, albedo):
    """DIB-R++ diffuse reflectance (reference :351)."""
    brdf = albedo / math.pi
    return sg_irradiance_inner_product(
        amplitude, direction, sharpness, normal) * brdf
