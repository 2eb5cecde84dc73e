"""Sun and moon positions for HUD astro symbology — no pyephem needed.

The reference computes sun/moon NED unit vectors with the ``ephem`` package
(reference video/hud.py:189-213 compute_sun_moon_ned). That package is not
in this environment, so this module implements the standard low-precision
algorithms from Meeus, *Astronomical Algorithms* (public formulas):

- solar position: mean anomaly / ecliptic longitude series (accuracy ~0.01°),
- lunar position: truncated ELP series, the largest longitude/latitude/
  parallax terms (accuracy ~0.3° — far below HUD symbol size),
- apparent topocentric azimuth/elevation via local sidereal time.

Both return NED unit vectors exactly as the reference's API does.

Port of the JAX package's ``video/ephemeris.py``: a copy.
"""

from __future__ import annotations

import math

D2R = math.pi / 180.0


def _julian_day(unixtime: float) -> float:
    return unixtime / 86400.0 + 2440587.5


def _gmst_deg(jd: float) -> float:
    """Greenwich mean sidereal time in degrees."""
    T = (jd - 2451545.0) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (jd - 2451545.0)
            + 0.000387933 * T * T - T * T * T / 38710000.0)
    return gmst % 360.0


def sun_radec(jd: float):
    """Geocentric apparent RA/Dec of the Sun (degrees), Meeus ch. 25."""
    T = (jd - 2451545.0) / 36525.0
    L0 = (280.46646 + 36000.76983 * T + 0.0003032 * T * T) % 360.0
    M = (357.52911 + 35999.05029 * T - 0.0001537 * T * T) % 360.0
    e = 0.016708634 - 0.000042037 * T - 0.0000001267 * T * T
    C = ((1.914602 - 0.004817 * T - 0.000014 * T * T) * math.sin(M * D2R)
         + (0.019993 - 0.000101 * T) * math.sin(2 * M * D2R)
         + 0.000289 * math.sin(3 * M * D2R))
    lon = L0 + C
    # apparent longitude (nutation + aberration)
    omega = 125.04 - 1934.136 * T
    lam = lon - 0.00569 - 0.00478 * math.sin(omega * D2R)
    eps = (23.439291 - 0.0130042 * T
           + 0.00256 * math.cos(omega * D2R))
    ra = math.degrees(math.atan2(
        math.cos(eps * D2R) * math.sin(lam * D2R), math.cos(lam * D2R)))
    dec = math.degrees(math.asin(
        math.sin(eps * D2R) * math.sin(lam * D2R)))
    return ra % 360.0, dec


def moon_radec(jd: float):
    """Geocentric RA/Dec of the Moon (degrees), truncated Meeus ch. 47."""
    T = (jd - 2451545.0) / 36525.0
    # fundamental arguments (degrees)
    Lp = (218.3164477 + 481267.88123421 * T) % 360.0   # mean longitude
    D = (297.8501921 + 445267.1114034 * T) % 360.0     # mean elongation
    M = (357.5291092 + 35999.0502909 * T) % 360.0      # sun mean anomaly
    Mp = (134.9633964 + 477198.8675055 * T) % 360.0    # moon mean anomaly
    F = (93.2720950 + 483202.0175233 * T) % 360.0      # argument of latitude

    def s(x):
        return math.sin(x * D2R)

    # largest periodic terms (degrees ×1e-6 in Meeus; kept > ~0.01°)
    dlon = (6.288774 * s(Mp) + 1.274027 * s(2 * D - Mp) + 0.658314 * s(2 * D)
            + 0.213618 * s(2 * Mp) - 0.185116 * s(M) - 0.114332 * s(2 * F)
            + 0.058793 * s(2 * D - 2 * Mp) + 0.057066 * s(2 * D - M - Mp)
            + 0.053322 * s(2 * D + Mp) + 0.045758 * s(2 * D - M)
            - 0.040923 * s(M - Mp) - 0.034720 * s(D) - 0.030383 * s(M + Mp))
    lat = (5.128122 * s(F) + 0.280602 * s(Mp + F) + 0.277693 * s(Mp - F)
           + 0.173237 * s(2 * D - F) + 0.055413 * s(2 * D - Mp + F)
           + 0.046271 * s(2 * D - Mp - F) + 0.032573 * s(2 * D + F))
    lon = Lp + dlon
    beta = lat
    eps = 23.439291 - 0.0130042 * T
    sl, cl = math.sin(lon * D2R), math.cos(lon * D2R)
    sb, cb = math.sin(beta * D2R), math.cos(beta * D2R)
    se, ce = math.sin(eps * D2R), math.cos(eps * D2R)
    ra = math.degrees(math.atan2(sl * ce - math.tan(beta * D2R) * se, cl))
    dec = math.degrees(math.asin(sb * ce + cb * se * sl))
    return ra % 360.0, dec


def radec_to_azalt(ra_deg, dec_deg, lat_deg, lon_deg, jd):
    """Apparent azimuth (from north, CW) and altitude in degrees."""
    lst = (_gmst_deg(jd) + lon_deg) % 360.0
    ha = (lst - ra_deg) * D2R
    lat = lat_deg * D2R
    dec = dec_deg * D2R
    sin_alt = (math.sin(lat) * math.sin(dec)
               + math.cos(lat) * math.cos(dec) * math.cos(ha))
    alt = math.asin(max(-1.0, min(1.0, sin_alt)))
    az = math.atan2(-math.sin(ha) * math.cos(dec),
                    math.sin(dec) - math.sin(lat) * sin_alt)
    # atan2 form above yields azimuth from north through east directly
    az_deg = math.degrees(az) % 360.0
    return az_deg, math.degrees(alt)


def _azalt_to_ned(az_deg, alt_deg):
    az = az_deg * D2R
    alt = alt_deg * D2R
    return [math.cos(az) * math.cos(alt),
            math.sin(az) * math.cos(alt),
            -math.sin(alt)]


def sun_moon_ned(lon_deg, lat_deg, alt_m, unixtime):
    """NED unit vectors toward the sun and moon — same contract as the
    reference's compute_sun_moon_ned (hud.py:189-213)."""
    jd = _julian_day(unixtime)
    sra, sdec = sun_radec(jd)
    mra, mdec = moon_radec(jd)
    saz, salt = radec_to_azalt(sra, sdec, lat_deg, lon_deg, jd)
    maz, malt = radec_to_azalt(mra, mdec, lat_deg, lon_deg, jd)
    return _azalt_to_ned(saz, salt), _azalt_to_ned(maz, malt)
